"""Generate librosa golden fixtures for the oracle-pinning tests (the port's
copy of ``aegis_tpu/tools/make_golden.py``: the same clips from the port's
``tools/signal_gen.py``, the same librosa calls, the same files).

The driver's correctness gate is "note-event F1 >= 0.99 vs the CPU *librosa*
reference" (BASELINE.md), but librosa is NOT installable in the TPU image
(zero egress, no wheel).  This script is the bridge: run it in ANY
environment where librosa is installed —

    pip install librosa
    python -m aegis_tpu_torch.tools.make_golden

— and it writes ``tests/golden/librosa_*.npz`` fixtures holding the outputs
of the exact librosa calls the reference engine makes
(librosa.pyin at /root/reference/aegis_engine_core/worker.py:9-15,
melspectrogram/power_to_db/rms at /root/reference/aegis_engine.py:22-27,67-70,
load-resampling at aegis_engine.py:22).  ``tests/test_golden.py`` then pins
``aegis_tpu.ref`` (and transitively the device kernels, which are
parity-tested against ``ref``) to real librosa semantics; it skips with a
pointed message while the fixtures are absent.  The port's ``ref/`` modules
are held equal to the JAX package's, so one set of fixtures pins both.

The clips are regenerated deterministically from tools/signal_gen.py
(same seeds), so no audio needs to be committed — only the small npz outputs.
librosa is imported inside ``main`` only.
"""

from __future__ import annotations

import os
import sys

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "golden")


def clips():
    from aegis_tpu_torch.tools.signal_gen import generate_test_track, two_tone

    return [
        ("two_tone_22050", 22050, two_tone(sr=22050)),
        ("ks_track_22050", 22050, generate_test_track(sr=22050)[0]),
        ("ks_track_44100", 44100, generate_test_track(sr=44100)[0]),
    ]


def main() -> None:
    try:
        import librosa
    except ImportError:
        print("librosa is not installed — run this in an environment with "
              "librosa to (re)generate the golden fixtures.", file=sys.stderr)
        sys.exit(2)

    from aegis_tpu_torch.config import PyinConfig

    cfg = PyinConfig()
    os.makedirs(GOLDEN_DIR, exist_ok=True)

    for name, sr, y in clips():
        y = np.asarray(y, np.float32)
        f0, vf, vp = librosa.pyin(
            y, fmin=cfg.fmin, fmax=cfg.fmax, sr=sr,
            frame_length=cfg.frame_length, hop_length=512,
            fill_na=np.nan)
        mel = librosa.feature.melspectrogram(
            y=y, sr=sr, n_fft=2048, hop_length=512, n_mels=128)
        mel_db = librosa.power_to_db(mel, ref=np.max)
        rms = librosa.feature.rms(y=y, frame_length=2048, hop_length=512)[0]
        out = os.path.join(GOLDEN_DIR, f"librosa_{name}.npz")
        np.savez_compressed(
            out, f0=f0, voiced_flag=vf, voiced_probs=vp,
            mel_db=mel_db.T.astype(np.float32), rms=rms.astype(np.float32),
            sr=sr, librosa_version=librosa.__version__)
        print(f"wrote {out} ({len(f0)} frames, librosa {librosa.__version__})")

    # load-resampling parity clip: 44.1k -> 22.05k (the reference's
    # librosa.load(sr=22050) path, soxr under the hood)
    _, _, y44 = clips()[2]
    y22 = librosa.resample(np.asarray(y44, np.float32), orig_sr=44100,
                           target_sr=22050)
    np.savez_compressed(
        os.path.join(GOLDEN_DIR, "librosa_resample_44to22.npz"),
        y22=y22.astype(np.float32), librosa_version=librosa.__version__)
    print("wrote resample fixture")


if __name__ == "__main__":
    main()
