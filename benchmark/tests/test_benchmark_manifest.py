"""BENCHMARK.json: names, units and the files each cell and metric is found by."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import manifest

BENCH = manifest.load()


def test_names_and_units_use_only_allowed_characters():
    assert manifest.check_names(BENCH) == []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} == {"frames_per_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] == "frames_per_s"
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(manifest.ROOT, c["file"]))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cells_files_are_found_by_name():
    assert manifest.missing_files(BENCH) == []
    for w in BENCH["workloads"]:
        ref = manifest.reference_module(w["config"])
        for fn in ("make_weights", "outputs", "errors", "video_flops"):
            assert callable(getattr(ref, fn))
        limits = manifest.load_json(manifest.limits_path(w["name"]))
        assert set(limits.pop("dry_run")) == set(limits)
        probe = ref.errors({}, {k: __import__("numpy").zeros((1, 1)) for k in ("rgb", "flow", "raft")})
        assert set(limits) == set(probe)
        assert manifest.per_layer_for(BENCH, w["name"])
    for m in BENCH["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def _copy_with_new_files(tmp_path):
    """A copy of the benchmark with a configuration, a traffic mix, a cell and
    a metric added as new files and entries, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = root / "benchmark"
    shutil.copy(b / "configs" / "i3d_pwc.json", b / "configs" / "i3d_pwc_copy.json")
    shutil.copy(b / "reference" / "i3d_pwc.py", b / "reference" / "i3d_pwc_copy.py")
    traffic = json.loads((b / "traffic" / "kinetics_packed.json").read_text())
    traffic["dry_run"]["corpus"]["clips"] = 3
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    shutil.copy(b / "limits" / "i3d_pwc.kinetics_packed.json",
                b / "limits" / "i3d_pwc_copy.tiny_mix.json")
    (b / "metrics" / "window.completed_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.completed)) or None\n")
    bench["configs"].append({"name": "i3d_pwc_copy", "source": "https://arxiv.org/abs/1705.07750",
                             "file": "benchmark/configs/i3d_pwc_copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "i3d_pwc_copy.tiny_mix", "config": "i3d_pwc_copy",
                               "traffic": "tiny_mix", "chips": 1, "why": "added as files"})
    bench["per_layer"].append({"name": "window.completed_count", "unit": "videos",
                               "better": "higher", "source": "program_counter",
                               "layer": "model step", "moves": "frames_per_s",
                               "workloads": ["i3d_pwc_copy.tiny_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_config_mix_and_metric_added_as_files_are_picked_up(tmp_path):
    root = _copy_with_new_files(tmp_path)
    b = str(root / "benchmark")
    bench = manifest.load(str(root / "BENCHMARK.json"))
    assert manifest.missing_files(bench, b) == []
    assert "window.completed_count" in [m["name"]
                                        for m in manifest.per_layer_for(bench, "i3d_pwc_copy.tiny_mix")]
    # the copy's own harness finds them by name, end to end, on the CPU
    env = {**os.environ, "PYTHONPATH": manifest.ROOT, "TMPDIR": str(tmp_path)}
    env.pop("VFT_CHECKPOINT_DIR", None)
    out = subprocess.run([sys.executable, os.path.join(b, "run.py"), "--workload",
                          "i3d_pwc_copy.tiny_mix", "--seed", "2147483659", "--seconds", "4",
                          "--trace", "1", "--dry-run"], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["window.completed_count"]["value"] >= 1
    assert list(result)[-1] == "checks"


def test_the_real_command_without_a_card_fails_and_prints_nothing(tmp_path, cuda_absent):
    out = subprocess.run([sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"),
                          "--workload", "i3d_pwc.kinetics_packed", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env={**os.environ, "TMPDIR": str(tmp_path)}, timeout=300,
                         cwd=manifest.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
