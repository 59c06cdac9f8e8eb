"""CPU tests of the benchmark's own parts: the copied generators, the
roofline count, the statistics, ``BENCHMARK.json`` against its rules, the
look-up of cells, configurations and metrics by name, and the run's
refusal without a card.  Run from the repository root:

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import roofline, run, stats, takes  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ------------------------------------------------------------- generators

@pytest.mark.parametrize("seed", [1, 7, 2**31 + 11, [5, 2]])
def test_bench_track_equals_the_programs(seed):
    from aegis_tpu_torch.tools import signal_gen

    want = signal_gen.generate_bench_track(12.0, 44100, seed=seed,
                                           return_truth=True)
    got = takes.generate_bench_track(12.0, 44100, seed=seed,
                                     return_truth=True)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("seed", [3, 8, 2**32 + 1])
def test_chord_progression_equals_the_programs(seed):
    from aegis_tpu_torch.tools import signal_gen

    for sr in (22050, 44100):
        want = signal_gen.generate_chord_progression(seed, sr)
        got = takes.generate_chord_progression(seed, sr)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("freq,dur", [(82.41, 0.6), (110.0, 0.2),
                                      (329.63, 0.45), (1046.5, 0.3)])
def test_karplus_strong_equals_lfilter(freq, dur):
    from aegis_tpu_torch.tools import signal_gen

    want = signal_gen.karplus_strong(freq, dur, 44100,
                                     rng=np.random.default_rng(4))
    got = takes.karplus_strong(freq, dur, 44100, rng=np.random.default_rng(4))
    assert np.array_equal(got, want)


def test_takes_keep_their_lengths_across_seeds():
    spec = {"generator": "bench_track", "lengths_s": [2, 3]}
    a = takes.make_takes(spec, 1, 22050)
    b = takes.make_takes(spec, 2**31 + 5, 22050)
    assert [len(p) for _, p in a] == [len(p) for _, p in b] == [44100, 66150]
    assert not np.array_equal(a[0][1], b[0][1])
    assert np.array_equal(a[0][1], takes.make_takes(spec, 1, 22050)[0][1])


def test_wav_bytes_decode_to_the_samples():
    from aegis_tpu_torch.io.audio import load_audio

    pcm = np.array([0, 1, -1, 32767, -32768, 1234], np.int16)
    y, sr = load_audio(takes.wav_bytes(pcm, 44100), sr=44100)
    assert sr == 44100 and np.array_equal(y, takes.pcm_float(pcm))


# --------------------------------------------------------------- roofline

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,T,n,w", [(1, 2625, 450, 101), (1, 5249, 450, 51),
                                     (3, 1152, 450, 101), (6, 1152, 450, 51),
                                     (16, 1152, 450, 101), (1, 40, 450, 101),
                                     (1, 5249, 900, 101),
                                     (1, 433, 2250, 501)])
def test_roofline_gives_chip_smokes_bounds(B, T, n, w):
    cs = _chip_smoke()
    want = (cs.kernel_bounds("viterbi_fwd", B, T, n, w)["bound_ms"]
            + cs.kernel_bounds("viterbi_back", B, T, n, w)["bound_ms"])
    assert roofline.decode_bound_s([(B, T)], n, w) * 1e3 == pytest.approx(
        want, rel=1e-12)


def test_pitch_grid_of_the_config_is_the_programs():
    from aegis_tpu_torch.config import PyinConfig

    cfg = run.load_json(run.HERE / "configs" / "v1_mono_44k.json")
    p = PyinConfig()
    for key, v in cfg["pyin"].items():
        assert getattr(p, key) == v, key
    n, w = roofline.pitch_grid(cfg["pyin"], 44100, 512)
    assert (n, w) == (p.n_pitch_bins, p.transition_width(44100, 512))


# ------------------------------------------------------------------ stats

def test_percentile_is_nearest_rank():
    vals = list(range(1, 201))
    assert stats.percentile(vals, 95) == 190
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(390.0, 0.5) == 780.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_union_gaps_and_cover():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)]
    assert stats.union(iv) == [(0, 3), (5, 9), (10, 10)]
    assert stats.covered(iv) == 7
    assert stats.gaps(iv, -1, 12) == [(-1, 0), (3, 5), (9, 10), (10, 12)]
    assert stats.covered(stats.clip(iv, 2, 6)) == 2


# ---------------------------------------------------------- BENCHMARK.json

def test_benchmark_json_keeps_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_torch"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "bench_torch/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (run.HERE / "e2e" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
        for wl in m["workloads"]:
            # every cell of a layer metric reports the metric it moves
            reported = [x["name"] for x in run.cell_metrics(
                BENCH, "end_to_end", wl)]
            assert m["moves"] in reported, (m["name"], wl)
    for w in BENCH["workloads"]:
        assert "setup_s" in [x["name"] for x in run.cell_metrics(
            BENCH, "end_to_end", w["name"])]
        assert len(run.cell_metrics(BENCH, "end_to_end", w["name"])) >= 2
        assert run.cell_metrics(BENCH, "per_layer", w["name"])


def test_limits_are_set_for_every_number():
    import importlib

    for w in BENCH["workloads"]:
        cfg = run.load_json(run.HERE / "configs" / f"{w['config']}.json")
        mix = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
        limits = cfg["check"]["limits"][mix["check"]]
        assert limits and all(v >= 0 for v in limits.values()), w["name"]
        check = importlib.import_module(f"bench_torch.checks.{mix['check']}")
        assert set(check.check([], cfg, mix, "cpu")) <= set(limits)


# ------------------------------------------------------- found by name

def test_a_new_metric_file_is_found_by_name(tmp_path):
    path = tmp_path / "new_metric.per_thing.py"
    path.write_text("def read(sl):\n    return 42.0\n")
    assert run.load_file_module(path).read(None) == 42.0
    bench = {"per_layer": [{"name": "a", "workloads": ["x"]}, {"name": "b"},
                           {"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in run.cell_metrics(bench, "per_layer", "x")] \
        == ["a", "b"]


def test_a_new_cell_finds_its_files_by_name(monkeypatch):
    """A cell added to BENCHMARK.json with existing configuration and mix
    names is run with no harness edit: ``run_cell`` looks both up by name
    and takes the load the mix names."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_import(name):
        seen["load"] = name
        raise Stop

    monkeypatch.setattr(run.importlib, "import_module", fake_import)
    bench = {"workloads": [{"name": "new_cell", "config": "v1_mono_44k",
                            "traffic": "folder_mono", "chips": 1}]}
    with pytest.raises(Stop):
        run.run_cell(bench, "new_cell", 1, 1.0, 0, "cpu")
    assert seen["load"] == "bench_torch.loads.folder"


# ------------------------------------------------------ no card, no result

def test_run_without_a_card_fails_and_imports_no_jax():
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['aegis_tpu'] = None; "
            "sys.argv = ['bench_torch/run.py', '--workload', "
            f"{BENCH['workloads'][0]['name']!r}, '--seed', '3', "
            "'--seconds', '1', '--trace', '0']; "
            "runpy.run_path('bench_torch/run.py', run_name='__main__')")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(ROOT / "build")}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stderr[-2000:]
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_takes_are_cached_by_generator_parameters_and_seed(tmp_path):
    spec = {"generator": "bench_track", "lengths_s": [2, 3]}
    plain = takes.make_takes(spec, 11, 22050)
    made = takes.make_takes(spec, 11, 22050, tmp_path)
    files = sorted(tmp_path.iterdir())
    assert len(files) == 2 and all(f.suffix == ".npy" for f in files)
    read = takes.make_takes(spec, 11, 22050, tmp_path)
    for (na, a), (nb, b), (nc, c) in zip(plain, made, read):
        assert na == nb == nc and np.array_equal(a, b)
        assert np.array_equal(a, c) and c.dtype == np.int16
    takes.make_takes(spec, 12, 22050, tmp_path)
    takes.make_takes({**spec, "lengths_s": [2]}, 11, 44100, tmp_path)
    assert len(list(tmp_path.iterdir())) == 5
    chords = {"generator": "chord_sections", "lengths_s": [2],
              "chords_a_section": 2, "chord_pool": [[[48, 52], 0.5]]}
    takes.make_takes(chords, 11, 22050, tmp_path)
    other = takes.make_takes({**chords, "chord_pool": [[[50, 54], 0.5]]},
                             11, 22050, tmp_path)
    assert len(list(tmp_path.iterdir())) == 7
    assert np.array_equal(other[0][1], takes.make_takes(
        {**chords, "chord_pool": [[[50, 54], 0.5]]}, 11, 22050)[0][1])
