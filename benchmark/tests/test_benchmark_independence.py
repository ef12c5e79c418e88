"""What the benchmark imports: never JAX or the JAX package, and the reference
nothing of the program (top-level module names compared whole)."""

import ast
import os
import subprocess
import sys

from benchmark.harness import manifest
from benchmark.harness.cell import FORBIDDEN_MODULES

REFERENCE_DIR = os.path.join(manifest.BENCH_DIR, "reference")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(top):
    for dirpath, _, files in os.walk(top):
        if ".cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in _sources(REFERENCE_DIR):
        found = set(_imports(path)) & {"video_features_torch", *FORBIDDEN_MODULES}
        assert not found, (path, found)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources(manifest.BENCH_DIR):
        assert not set(_imports(path)) & set(FORBIDDEN_MODULES), path


def test_a_dry_run_process_holds_no_jax(tmp_path):
    """A whole rehearsal in a fresh process; the harness itself refuses to
    print a result when the window closes with any of them loaded."""
    code = ("import sys, json; sys.argv = ['run.py', '--workload', 'i3d_pwc.kinetics_packed',"
            " '--seed', '9', '--seconds', '3', '--trace', '0', '--dry-run'];"
            " import runpy; rc = 0\n"
            "try:\n    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "mods = sorted({m.split('.')[0] for m in sys.modules} & set(%r))\n"
            "print(json.dumps({'rc': rc, 'forbidden': mods}), file=sys.stderr)\n"
            % (os.path.join(manifest.BENCH_DIR, "run.py"), FORBIDDEN_MODULES))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "TMPDIR": str(tmp_path)}, timeout=600,
                         cwd=manifest.ROOT)
    last = out.stderr.strip().splitlines()[-1]
    assert '"rc": 0' in last and '"forbidden": []' in last, out.stderr[-2000:]


def test_top_level_names_are_compared_whole():
    from benchmark.harness import cell

    sys.modules["video_features_tpu_lookalike"] = sys
    try:
        assert "video_features_tpu_lookalike" not in cell.forbidden_modules()
        assert cell.forbidden_modules() == []
    finally:
        del sys.modules["video_features_tpu_lookalike"]
