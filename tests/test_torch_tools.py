"""The port's validation tools against the JAX package's, on the CPU.

``ref/pipeline_ref.py`` is a copy (the same rows); ``validate_device``,
``benchmark`` and ``inharmonic_sweep`` run the port's engines on the CPU
and give the JAX tools' F1 fields on the same clips; ``utils/prof.py``
leaves its ranges in a ``torch.profiler`` trace.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.ref import pipeline_ref as jpipe
from aegis_tpu.tools import benchmark as jbench
from aegis_tpu.tools import inharmonic_sweep as jsweep
from aegis_tpu.tools import validate_device as jvalidate

from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.ref import pipeline_ref as tpipe
from aegis_tpu_torch.tools import benchmark as tbench
from aegis_tpu_torch.tools import inharmonic_sweep as tsweep
from aegis_tpu_torch.tools import validate_device as tvalidate
from aegis_tpu_torch.tools.signal_gen import generate_test_track
from aegis_tpu_torch.utils import prof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TIMES = ("analyze_seconds", "extract_seconds", "realtime_factor")


@pytest.mark.parametrize("financial", [False, True])
@pytest.mark.parametrize("sr", [22050, 44100])
def test_pipeline_ref_copy_equals_its_original(financial, sr):
    y = generate_test_track(sr=sr)[0][:2 * sr]
    got = tpipe.run_analyze_ref(y, tconfig.AudioConfig(sample_rate=sr),
                                tconfig.PyinConfig(), financial=financial)
    ref = jpipe.run_analyze_ref(y, AudioConfig(sample_rate=sr), PyinConfig(),
                                financial=financial)
    assert sorted(got) == sorted(ref)
    assert got["f0"].shape == (AudioConfig(sample_rate=sr).n_frames(len(y)),)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_oracle_raw_is_the_jax_ref_engines():
    """The tool's oracle rows are what the JAX facade's backend="ref" engine
    returns, for v1 (its raw dict) and financial (its analysis)."""
    from aegis_tpu.engine.engine import AegisEngine as JaxEngine
    from aegis_tpu.engine.financial import AegisFinancialEngine as JaxFin
    from aegis_tpu_torch.engine.financial import AegisFinancialEngine
    y = generate_test_track(sr=22050)[0][:3 * 22050]
    for financial in (False, True):
        eng = (AegisFinancialEngine(device="cpu") if financial
               else AegisEngine(sample_rate=22050, device="cpu"))
        got = tvalidate._oracle_raw(y, eng, financial)
        ref = (JaxFin(backend="ref").analyze(y) if financial
               else JaxEngine(sample_rate=22050, backend="ref").audio_to_midi(y))
        assert sorted(got) == sorted(ref), financial
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                assert got[k] == ref[k], k


def test_validate_matches_the_jax_tool():
    """Every gating and informative F1 of the JAX tool's quick run, on the
    same clips; the gate passes."""
    got = tvalidate.validate(include_bench=False, quiet=True, device="cpu")
    ref = jvalidate.validate(include_bench=False, quiet=True)
    assert got["pass"] and ref["pass"]
    assert got == ref
    assert len(got["clips"]) == 9


def test_benchmark_matches_the_jax_tool():
    got = tbench.run_benchmark(0.4, device="cpu")
    ref = jbench.run_benchmark(0.4, backend="device")
    for k in TIMES:
        assert got.pop(k) > 0 and ref.pop(k) > 0
    assert got == ref
    assert got["truth_notes"] == 8
    assert got["aegis"]["f1"] > got["naive_baseline"]["f1"]


def test_sweep_matches_the_jax_tool():
    kw = dict(b_values=(1e-4,), mono_duration=5.0, poly_seeds=(1,),
              quiet=True)
    got = tsweep.sweep(device="cpu", **kw)
    ref = jsweep.sweep(**kw)
    assert got == ref
    assert set(got["f1_by_B"]["0.0001"]) == {"v1", "financial", "neural",
                                              "poly_mean", "poly_min"}


def test_validate_command(tmp_path):
    """``python -m aegis_tpu_torch validate --quick --device cpu``: exit 0
    and the tool's JSON on the last line."""
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "validate", "--quick",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["pass"] and out["threshold"] == 0.99
    assert "# synthetic_track_44k@44100: v1=1.0000" in proc.stderr


def test_phase_and_device_trace(tmp_path):
    """``phase`` leaves its range in a CPU profiler trace and logs its
    seconds unless quiet; ``device_trace`` writes a Chrome trace holding
    the engine's ranges."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    prof.log.addHandler(handler)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with prof.phase("test.quiet", quiet=True):
                torch.ones(8).sum()
            with prof.phase("test.loud"):
                torch.ones(8).sum()
    finally:
        prof.log.removeHandler(handler)
    names = {e.key for e in p.key_averages()}
    assert {"test.quiet", "test.loud"} <= names
    assert [r.getMessage().split(":")[0] for r in records] == ["test.loud"]

    eng = AegisEngine(sample_rate=22050, device="cpu")
    y = generate_test_track(sr=22050)[0][:22050]
    with prof.device_trace(str(tmp_path / "trace")):
        eng.extract_events(eng.audio_to_midi(y), None)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = {e.get("name") for e in trace["traceEvents"]}
    assert {"aegis.perception", "aegis.extract"} <= spans
