"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the measured package's name begins with the JAX
package's), and the reference loads nothing of the measured package."""

import ast
import json
import subprocess
import sys

import harness

JAX_NAMES = {"jax", "jaxlib", "flax", "unified_cvo_tpu"}


def _top_levels(code: str) -> set:
    """Top-level names of sys.modules after running `code` in a fresh
    interpreter with the benchmark on the path."""
    paths = [str(harness.ROOT), str(harness.BENCH), str(harness.BENCH / "reference")]
    prog = (f"import sys; sys.path[:0] = {paths!r}\n" + code
            + "\nimport json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    code = ("import bench_tiny\n"
            "import harness\n"
            "for cell in sorted(bench_tiny.TINY):\n"
            "    assert bench_tiny.run(cell)['correct']\n"
            "spec = harness.with_pending(harness.load_spec())\n"
            "for m in spec['end_to_end'] + spec['per_layer']:\n"
            "    harness.load_module('metrics', m['name'])\n"
            "for kind in ('work', 'traffic', 'drivers'):\n"
            "    for p in (harness.BENCH / kind).glob('*.py'):\n"
            "        harness.load_module(kind, p.stem)\n"
            "import calibrate")
    code = "sys.path.insert(0, " + repr(str(harness.BENCH / "tests")) + ")\n" + code
    names = _top_levels(code)
    assert "unified_cvo_tpu_torch" in names        # the run did load the package
    assert not names & JAX_NAMES, names & JAX_NAMES


def test_the_reference_loads_nothing_of_the_package():
    code = ("import torch, cvo_ref, stereo_ref, stereo_ops\n"
            "x = torch.rand(4096, 3) * 10\n"
            "m = torch.ones(4096)\n"
            "p = dict(sigma=0.1, sp_thres=0.0006, is_using_range_ell=0, c=7.0, d=7.0)\n"
            "idx, slots = cvo_ref.candidate_list(p, torch.tensor(0.5), x, m, x + 0.01, m,\n"
            "                                    torch.eye(3), torch.zeros(3))\n"
            "cvo_ref.moments(p, torch.tensor(0.5), x, m, slots, torch.eye(3), torch.zeros(3))\n"
            "img = (torch.rand(60, 200, 3) * 255).to(torch.uint8)\n"
            "cam = dict(fx=100.0, fy=100.0, cx=100.0, cy=30.0, baseline=0.5)\n"
            "stereo_ref.stereo_frontend(img, img.roll(3, 1), cam, 32768, 64)")
    names = _top_levels(code)
    assert "unified_cvo_tpu_torch" not in names
    assert not names & JAX_NAMES


def test_no_source_imports_jax_or_the_package_where_it_must_not():
    for path in harness.BENCH.rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops.add(node.module.split(".")[0])
        assert not tops & JAX_NAMES, (path, tops & JAX_NAMES)
        if path.parent.name == "reference":
            assert "unified_cvo_tpu_torch" not in tops, path


def test_run_without_a_card_prints_no_result(tmp_path):
    """Here (no CUDA) run.py exits 2 and prints nothing on standard output;
    so it does in a directory that holds only BENCHMARK.json and the
    benchmark's files (no measured package)."""
    import shutil

    root = tmp_path / "bare"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for cwd in (harness.ROOT, root):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "geo16k-fleet32",
                              "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=str(cwd))
        assert out.returncode == 2 and out.stdout.strip() == "", (cwd, out.stdout, out.stderr)
