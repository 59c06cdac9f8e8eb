"""PitchNet (PyTorch): the learned monophonic pitch tracker behind
``pitch_backend="neural"``, its inference programs and its training step.

Counterpart of ``aegis_tpu/models/pitchnet.py`` (the loop that trains it is
``models/train.py``; ``run_analyze_neural_batch`` and the training step
also run data-parallel over a ``utils/mesh.py`` mesh of ranks).  A small
spectrum-input MLP maps a 2048-sample window's standardized log-magnitude
spectrum to a 192-bin pitch distribution (25-cent bins from one semitone
below E2) and a voicing logit.  A whole track is one program on the device:

    y ──► mel ──► dB ──► rake mask, onset envelope     (caller's rate / hop)
      └─► RMS
      └─► windows (22 050 Hz) ──► |DFT| (matmul) ──► standardize ──► MLP
            ──► softmax, 9-bin local expectation ──► 5-frame NaN-aware
            cents median ──► onset backfill

No Viterbi: every frame decodes on its own.  The net runs at 22 050 Hz; at
another rate the non-pitch rows keep the caller's grid and the pitch head
reads a host resample, framed with a uniform hop where ``hop * 22050 / sr``
is integral and gathered at rounded centres otherwise.  The streamed mode
(``run_analyze_neural_streamed``) cuts a long track into int16 slabs with
one scale a track and reproduces the fused program's rows.

The checkpoint is the JAX package's, copied byte for byte to
``models/weights/pitchnet_v1.npz``; ``params_from_numpy`` maps its flax
tree onto ``PitchNet``'s parameters (``Linear.weight = kernel.T``) and
``params_to_numpy`` back, so ``save_params`` writes the JAX layout.  The
matmuls run in float32 with TF32 off (``resolve_device``), the training
step's too.  The NumPy oracle of the post-processing is
``ref/pitchnet_post_ref.py``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import NOTE_E2_HZ, AudioConfig, PyinConfig
from aegis_tpu_torch.core import dsp, masks
from aegis_tpu_torch.core.analyze import (_FIN_ROWS, _V1_ROWS, _pack,
                                          _unpack, bucket_length,
                                          check_transport, dequant_transport,
                                          financial_tail, ingest,
                                          pad_to_bucket, quantize_pcm16,
                                          quantize_tracks, upload)
from aegis_tpu_torch.core.cqt import onset_from_db
from aegis_tpu_torch.core.tables import tables_from_numpy
from aegis_tpu_torch.utils.mesh import SOLO, Mesh, resolve_mesh
from aegis_tpu_torch.utils.prof import phase

SR_NATIVE = 22050  # the net is trained at this rate; other rates resample
NEURAL_TRANSPORTS = ("int8", "int16", "float32")
WIN = 2048
N_RFFT = WIN // 2 + 1
FMIN_HZ = float(NOTE_E2_HZ * 2.0 ** (-1.0 / 12.0))  # one semitone below E2
CENTS_PER_BIN = 25.0
N_BINS = 192  # covers FMIN .. FMIN * 2^(191*25/1200) ~ 1226 Hz (above C6)
HIDDEN = (512, 256)

# Bump whenever featurize()/decode semantics change: a checkpoint trained
# against different features silently mistracks, so load_params refuses
# mismatched versions instead.
FEATURE_VERSION = 1

_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights",
                                "pitchnet_v1.npz")


# --------------------------------------------------------------------- model


class PitchNet(nn.Module):
    """Dense layers with ReLU, then two heads: pitch logits (N_BINS) and a
    voicing logit.  The flax model's ``Dense_0 .. Dense_{h-1}`` are
    ``trunk``, ``Dense_h`` is ``pitch`` and ``Dense_{h+1}`` is ``voiced``."""

    def __init__(self, hidden: Tuple[int, ...] = HIDDEN):
        super().__init__()
        dims = (N_RFFT,) + tuple(hidden)
        self.trunk = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.pitch = nn.Linear(dims[-1], N_BINS)
        self.voiced = nn.Linear(dims[-1], 1)

    def forward(self, feats: torch.Tensor):
        """(B, N_RFFT) -> ((B, N_BINS), (B,))."""
        x = feats
        for layer in self.trunk:
            x = torch.relu(layer(x))
        return self.pitch(x), self.voiced(x)[..., 0]


def params_from_numpy(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's nested ``{"Dense_k": {"kernel", "bias"}}`` of NumPy
    arrays -> a ``PitchNet`` state_dict (float32, on the CPU)."""
    n = len(tree)

    def linear(k: int) -> Dict[str, torch.Tensor]:
        d = tree[f"Dense_{k}"]
        return {"weight": torch.from_numpy(
                    np.ascontiguousarray(np.asarray(d["kernel"], np.float32).T)),
                "bias": torch.from_numpy(np.asarray(d["bias"], np.float32).copy())}

    names = [f"trunk.{k}" for k in range(n - 2)] + ["pitch", "voiced"]
    return {f"{name}.{p}": v for k, name in enumerate(names)
            for p, v in linear(k).items()}


def pitchnet_from_numpy(tree: Dict, device="cuda") -> PitchNet:
    """A ``PitchNet`` in eval mode on ``device`` holding ``tree``'s weights
    (the hidden widths are read off the tree)."""
    device = resolve_device(device)
    hidden = tuple(int(np.asarray(tree[f"Dense_{k}"]["bias"]).shape[0])
                   for k in range(len(tree) - 2))
    net = PitchNet(hidden)
    net.load_state_dict(params_from_numpy(tree))
    return net.to(device).eval()


def load_meta(path: Optional[str] = None) -> Dict:
    """Checkpoint metadata ({} for pre-metadata checkpoints)."""
    path = path or _DEFAULT_WEIGHTS
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


def load_params(path: Optional[str] = None) -> Dict:
    """Load a checkpoint as a nested f32 NumPy param dict (the flax tree).
    Raises FileNotFoundError when no checkpoint exists and ValueError on a
    feature-version mismatch (weights trained against different
    featurize() semantics would silently mistrack)."""
    path = path or _DEFAULT_WEIGHTS
    with np.load(path) as z:
        tree: Dict = {}
        ver = None
        hidden = None
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(bytes(z[key]).decode())
                ver = meta.get("feature_version")
                hidden = meta.get("hidden")
                continue
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key].astype(np.float32)
    if ver != FEATURE_VERSION:  # includes pre-metadata checkpoints (None)
        raise ValueError(
            f"checkpoint {path} has feature_version {ver}, this build "
            f"expects {FEATURE_VERSION}; retrain with "
            f"python -m aegis_tpu_torch train")
    if hidden is not None and tuple(hidden) != HIDDEN:
        raise ValueError(
            f"checkpoint {path} was trained with hidden={tuple(hidden)}, "
            f"this build uses {HIDDEN}")
    return tree


def have_default_weights() -> bool:
    return os.path.exists(_DEFAULT_WEIGHTS)


_DEVICE_PARAMS: Dict[str, PitchNet] = {}
_PARAMS_LOCK = threading.Lock()   # the server's request threads load it too


def default_params(device="cuda") -> PitchNet:
    """The default checkpoint as a ``PitchNet`` on ``device``, loaded once
    per process and device: the one shared loader behind every facade's
    neural backend."""
    device = resolve_device(device)
    key = str(device)
    with _PARAMS_LOCK:
        if key not in _DEVICE_PARAMS:
            _DEVICE_PARAMS[key] = pitchnet_from_numpy(load_params(), device)
        return _DEVICE_PARAMS[key]


# ------------------------------------------------------- per-frame stages


def _tables(sample_rate: int, n_fft: int, n_mels: int, device: torch.device):
    """The STFT and mel constants (core.tables.tables_from_numpy) of a
    configuration; hop_length does not enter them."""
    return tables_from_numpy(AudioConfig(sample_rate=sample_rate,
                                         n_fft=n_fft, n_mels=n_mels),
                             PyinConfig(), device)


def featurize(windows: torch.Tensor) -> torch.Tensor:
    """(B, WIN) f32 audio windows -> (B, N_RFFT) standardized log-magnitude.
    The standard deviation is the population one (divide by N), as
    ``jnp.std``; ``torch.std``'s default divides by N - 1."""
    tb = _tables(SR_NATIVE, WIN, 128, windows.device)
    w = windows * tb.window[None, :]
    re = w @ tb.dft_cos
    im = w @ tb.dft_sin
    logm = 0.5 * torch.log1p(re * re + im * im)
    mu = torch.mean(logm, dim=-1, keepdim=True)
    sd = torch.sqrt(torch.mean((logm - mu) ** 2, dim=-1, keepdim=True))
    return (logm - mu) / (sd + 1e-5)


def bin_centers_cents() -> np.ndarray:
    return (np.arange(N_BINS) * CENTS_PER_BIN).astype(np.float32)


def decode_f0(pitch_logits: torch.Tensor, voiced_logit: torch.Tensor):
    """Logits -> (f0_hz, voiced_prob): local expectation over the 9 bins
    around the argmax (the first of equal maxima), CREPE's decoding."""
    p = torch.softmax(pitch_logits, dim=-1)  # (B, N_BINS)
    centers = torch.from_numpy(bin_centers_cents()).to(p.device)
    best = torch.argmax(p, dim=-1)  # (B,)
    offs = torch.arange(-4, 5, device=p.device)
    idx = torch.clamp(best[:, None] + offs[None, :], 0, N_BINS - 1)
    pw = torch.gather(p, -1, idx)
    cw = centers[idx]
    cents = (pw * cw).sum(-1) / (pw.sum(-1) + 1e-9)
    f0 = FMIN_HZ * torch.exp2(cents / 1200.0)
    return f0, torch.sigmoid(voiced_logit)


def _nanmedian(stack: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, ``jnp.nanmedian``'s way: the
    midpoint ``(low + high) * 0.5`` of the two middle non-NaN values (the
    one middle value twice for an odd count); NaN where all are NaN.
    ``torch.nanmedian`` returns the lower middle value instead."""
    s = torch.sort(stack, dim=-1).values  # NaNs sort last
    count = (~torch.isnan(stack)).sum(dim=-1, keepdim=True)
    low = torch.clamp((count - 1) // 2, min=0)
    high = count // 2
    high = torch.minimum(high, torch.clamp(count - 1, min=0))
    lo_v = torch.gather(s, -1, low)[..., 0]
    hi_v = torch.gather(s, -1, high)[..., 0]
    return (lo_v + hi_v) * 0.5


def smooth_f0_median(f0: torch.Tensor, voiced: torch.Tensor,
                     smooth: int = 5) -> torch.Tensor:
    """NaN-aware running median over the cents track on voiced frames;
    unvoiced frames come back NaN.  Oracle: ref/pitchnet_post_ref.py."""
    nan = torch.tensor(float("nan"), dtype=f0.dtype, device=f0.device)
    cents = torch.where(voiced, 1200.0 * torch.log2(f0 / FMIN_HZ), nan)
    if smooth > 1:
        half = smooth // 2
        T = cents.shape[0]
        # NaN padding (not edge): out-of-track frames contribute nothing,
        # which keeps the streamed slabs equal to the fused program at
        # track boundaries
        cp = F.pad(cents, (half, half), value=float("nan"))
        stack = torch.stack([cp[j:j + T] for j in range(smooth)], dim=-1)
        cents = torch.where(torch.isnan(cents), cents, _nanmedian(stack))
    return FMIN_HZ * torch.exp2(cents / 1200.0)


def _shift_left(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x[t + s], ``fill`` past the end."""
    out = torch.full_like(x, fill)
    if s < x.shape[0]:
        out[: x.shape[0] - s] = x[s:]
    return out


def _shift_right(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x[t - s], ``fill`` before the start."""
    out = torch.full_like(x, fill)
    if s < x.shape[0]:
        out[s:] = x[: x.shape[0] - s]
    return out


def _onset_backfill(pitch: Dict[str, torch.Tensor], onset_env: torch.Tensor,
                    frames_per_second: float,
                    env_max: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Extend voicing backward toward the attack at spectral-flux onsets.

    A window-centred spectrum classifier hears a pluck a few frames after
    its attack; the onset envelope marks the physical attack.  A frame is
    filled when it is unvoiced, a voiced run starts within ~95 ms after it
    (max_fill), and a strong onset peak (> 0.2 of the envelope maximum)
    that leads into a voiced run within ~140 ms (k) lies between a pYIN
    lock delay (~45 ms) and k frames before it; filled frames inherit the
    run's first f0 / vprob.  ``env_max``: the track-global envelope maximum
    (the streamed slabs pass it; default the maximum of ``onset_env``)."""
    k = max(int(round(0.14 * frames_per_second)), 1)       # peak window
    max_fill = max(int(round(0.095 * frames_per_second)), 1)
    lock = max(int(round(0.045 * frames_per_second)), 0)   # pyin lock delay

    voiced, f0, vprob = (pitch["voiced_flag"], pitch["f0"],
                         pitch["voiced_probs"])

    def future(width):
        near = voiced
        ff, fp = f0, vprob
        for s in range(1, width + 1):
            sv = _shift_left(voiced, s, False)
            take = ~near & sv
            ff = torch.where(take, _shift_left(f0, s, float("nan")), ff)
            fp = torch.where(take, _shift_left(vprob, s, 0.0), fp)
            near = near | sv
        return near, ff, fp

    near_k, _, _ = future(k)
    near_fill, fut_f0, fut_p = future(max_fill)

    prev = torch.cat([onset_env[:1], onset_env[:-1]])
    nxt = torch.cat([onset_env[1:], onset_env[-1:]])
    if env_max is None:  # fused: track max; streamed slabs pass the global
        env_max = torch.max(onset_env)
    peak = (onset_env >= prev) & (onset_env >= nxt) & (
        onset_env > 0.2 * env_max)
    anchor = peak & near_k  # an attack that leads into a voiced run
    seen = anchor if lock == 0 else torch.zeros_like(anchor)
    for s in range(max(lock, 1), k + 1):
        seen = seen | _shift_right(anchor, s, False)
    add = ~voiced & near_fill & seen
    return {
        "f0": torch.where(add, fut_f0, f0),
        "voiced_flag": voiced | add,
        "voiced_probs": torch.where(add, fut_p, vprob),
    }


def _neural_pitch(params: PitchNet, frames: torch.Tensor, smooth: int = 5,
                  valid: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Per-frame net outputs -> pitch rows, with a ``smooth``-frame
    NaN-aware median over the cents track (the net decodes every frame
    independently; the median removes isolated octave flips).  ``valid``
    (bool (T,)) forces frames outside it unvoiced before smoothing (the
    streamed mode's synthetic before-track halo)."""
    with torch.no_grad():
        logits, vlogit = params(featurize(frames))
    f0, vprob = decode_f0(logits, vlogit)
    # 0.4, not 0.5: onset windows (half silence + pluck) sit on the voicing
    # decision boundary, and a symmetric cut lags real attacks
    voiced = vprob > 0.4
    if valid is not None:
        voiced = voiced & valid
        vprob = torch.where(valid, vprob, 0.0)
    f0 = smooth_f0_median(f0, voiced, smooth)
    return {"f0": f0, "voiced_flag": voiced, "voiced_probs": vprob}


# ------------------------------------------------------------- the programs


def _neural_host_rows(y: torch.Tensor, rake_sensitivity: float,
                      sample_rate: int, hop_length: int, n_fft: int,
                      n_mels: int) -> Dict[str, torch.Tensor]:
    """mel / rake / RMS / onset at the caller's own rate and hop: the
    non-pitch rows of core.analyze.analyze_program, the onset flux taken
    from the same dB array."""
    tables = _tables(sample_rate, n_fft, n_mels, y.device)
    mel_db = dsp.power_to_db(dsp.melspectrogram_t(y, hop_length, tables))
    return {
        "mel_db": mel_db,
        "rake_mask": masks.detect_rake(mel_db, hop_length, sample_rate,
                                       rake_sensitivity),
        "rms": dsp.rms(y, WIN, hop_length),
        "onset_env": onset_from_db(mel_db),
    }


def _neural_native_rows(y_q, scale, rake_sensitivity, params, sample_rate,
                        hop_length, n_fft, n_mels):
    """Body of the native-rate (22 050 Hz, one input) programs; ``scale``'s
    rank and ``y_q``'s dtype select the transport (dequant_transport)."""
    y = dequant_transport(y_q, scale)
    out = _neural_host_rows(y, rake_sensitivity, sample_rate, hop_length,
                            n_fft, n_mels)
    frames = dsp.frame_signal(y, WIN, hop_length, "constant")  # (T, WIN)
    out.update(_onset_backfill(_neural_pitch(params, frames),
                               out["onset_env"], sample_rate / hop_length))
    return out


def analyze_neural_program_packed(y_q, scale, rake_sensitivity, params,
                                  sample_rate: int, hop_length: int,
                                  n_fft: int, n_mels: int,
                                  include_mel: bool = True) -> torch.Tensor:
    """The v1 Perception Phase with PitchNet in place of pYIN: mel, rake,
    RMS, onset envelope and neural f0 / voicing in one program, packed as
    core.analyze._V1_ROWS (native rate, one input)."""
    out = _neural_native_rows(y_q, scale, rake_sensitivity, params,
                              sample_rate, hop_length, n_fft, n_mels)
    return _pack(out, _V1_ROWS, include_mel)


def _neural_dual_rows(y_q, scale, y22_q, scale22, centers, rake_sensitivity,
                      params, sample_rate, hop_length, n_fft, n_mels,
                      uniform_hop22):
    """Body of the two-rate programs: base rows at the caller's rate and
    hop, the pitch head on the 22 050 Hz resample (uniform framing, or a
    gather of windows at rounded centres)."""
    y = dequant_transport(y_q, scale)
    out = _neural_host_rows(y, rake_sensitivity, sample_rate, hop_length,
                            n_fft, n_mels)
    T = out["rms"].shape[0]
    y22 = dequant_transport(y22_q, scale22)
    if uniform_hop22:
        frames = dsp.frame_signal(y22, WIN, uniform_hop22, "constant")[:T]
    else:
        pad = WIN // 2
        y22p = F.pad(y22, (pad, pad))
        idx = centers[:T, None] + torch.arange(WIN, device=y22.device)[None, :]
        frames = y22p[torch.clamp(idx, 0, y22p.shape[0] - 1)]
    out.update(_onset_backfill(_neural_pitch(params, frames),
                               out["onset_env"], sample_rate / hop_length))
    return out


def analyze_neural_program_dual(y_q, scale, y22_q, scale22, centers,
                                rake_sensitivity, params, sample_rate: int,
                                hop_length: int, n_fft: int, n_mels: int,
                                include_mel: bool = True,
                                uniform_hop22: int = 0) -> torch.Tensor:
    """Two-rate variant for rates other than 22 050 Hz: mel / rake / RMS /
    onset on the original-rate signal with the original hop, the pitch head
    on the 22 050 Hz resample, framed uniformly when hop * 22050 / sr is
    integral (``uniform_hop22`` > 0; 44 100 Hz / 512 -> 256) or gathered at
    per-frame rounded centres otherwise."""
    out = _neural_dual_rows(y_q, scale, y22_q, scale22, centers,
                            rake_sensitivity, params, sample_rate,
                            hop_length, n_fft, n_mels, uniform_hop22)
    return _pack(out, _V1_ROWS, include_mel)


def analyze_neural_financial_dual(y_q, scale, y22_q, scale22, centers,
                                  rake_sensitivity, params, sample_rate: int,
                                  hop_length: int, n_fft: int, n_mels: int,
                                  include_mel: bool = True,
                                  use_guitar_filters: bool = True,
                                  uniform_hop22: int = 0) -> torch.Tensor:
    """Two-rate financial variant: the dual base rows plus the guitar
    filters and trend stack (core.analyze.financial_tail), as _FIN_ROWS."""
    out = _neural_dual_rows(y_q, scale, y22_q, scale22, centers,
                            rake_sensitivity, params, sample_rate,
                            hop_length, n_fft, n_mels, uniform_hop22)
    audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                        n_fft=n_fft, n_mels=n_mels)
    return _pack(financial_tail(out, audio, use_guitar_filters),
                 _FIN_ROWS, include_mel)


def analyze_neural_financial_packed(y_q, scale, rake_sensitivity, params,
                                    sample_rate: int, hop_length: int,
                                    n_fft: int, n_mels: int,
                                    include_mel: bool = True,
                                    use_guitar_filters: bool = True
                                    ) -> torch.Tensor:
    """The financial Perception Phase with PitchNet in place of pYIN: the
    neural base rows plus core.analyze.financial_tail, as _FIN_ROWS."""
    out = _neural_native_rows(y_q, scale, rake_sensitivity, params,
                              sample_rate, hop_length, n_fft, n_mels)
    audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                        n_fft=n_fft, n_mels=n_mels)
    return _pack(financial_tail(out, audio, use_guitar_filters),
                 _FIN_ROWS, include_mel)


# --------------------------------------------------------- the streamed mode


def _neural_mel_peak(y16, scale, sample_rate: int, hop_length: int,
                     n_fft: int, n_mels: int, keep_lo: int = 0,
                     keep_hi: int = -1) -> torch.Tensor:
    """Pass 1a of the streamed mode: a slab's mel-power peak over its
    interior frames [keep_lo, keep_hi) (the outermost frames of an extended
    slab are reflect-padding windows whose power can exceed any real
    frame's)."""
    tables = _tables(sample_rate, n_fft, n_mels, y16.device)
    mel = dsp.melspectrogram_t(dequant_transport(y16, scale), hop_length,
                               tables)
    return torch.max(mel[keep_lo:keep_hi])


def _mel_db_with_ref(mel: torch.Tensor, ref_power: torch.Tensor
                     ) -> torch.Tensor:
    """power_to_db with an explicit reference: with ref = the track-global
    mel maximum the fused path's max - 80 floor is the constant -80."""
    amin = 1e-10
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel, amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp_min(ref_power, amin))
    return torch.clamp_min(log_spec, -80.0)


def _neural_onset_max(y16, scale, ref_power, n_invalid_left: int,
                      sample_rate: int, hop_length: int, n_fft: int,
                      n_mels: int, keep_lo: int = 0,
                      keep_hi: int = -1) -> torch.Tensor:
    """Pass 1b: a slab's onset-flux maximum over its interior frames, with
    the global dB reference; feeds the backfill's track-global 20 % peak
    threshold."""
    tables = _tables(sample_rate, n_fft, n_mels, y16.device)
    mel = dsp.melspectrogram_t(dequant_transport(y16, scale), hop_length,
                               tables)
    env = onset_from_db(_mel_db_with_ref(mel, ref_power))
    idx = torch.arange(env.shape[0], device=env.device)
    env = torch.where(idx >= n_invalid_left + 1, env, 0.0)
    return torch.max(env[keep_lo:keep_hi])


def _neural_slab_program(y16, scale, y22_16, scale22, rake_sensitivity,
                         params, ref_power, onset_ref, n_invalid_left: int,
                         n_valid_right: int, sample_rate: int,
                         hop_length: int, n_fft: int, n_mels: int,
                         include_mel: bool = False,
                         hop22: int = 0) -> torch.Tensor:
    """Pass 2: a slab's rows with the track-global mel-power dB reference
    and onset maximum.  hop22 = 0 is the native one-input layout."""
    y = dequant_transport(y16, scale)
    # slab 0's leading halo carries reflected audio for the mel path and
    # the last slab's tail the bucket-end reflection; RMS and the pitch
    # framing pad with zeros, so both regions are zero for them
    s_idx = torch.arange(y.shape[0], device=y.device)
    y_zero = torch.where((s_idx >= n_invalid_left * hop_length)
                         & (s_idx < n_valid_right), y, 0.0)
    tables = _tables(sample_rate, n_fft, n_mels, y.device)
    mel_db = _mel_db_with_ref(dsp.melspectrogram_t(y, hop_length, tables),
                              ref_power)
    out = {
        "mel_db": mel_db,
        "rake_mask": masks.detect_rake(mel_db, hop_length, sample_rate,
                                       rake_sensitivity),
        "rms": dsp.rms(y_zero, WIN, hop_length),
        "onset_env": onset_from_db(mel_db),
    }
    T = out["rms"].shape[0]
    if hop22:
        y22 = dequant_transport(y22_16, scale22)
        s22 = torch.arange(y22.shape[0], device=y22.device)
        y22 = torch.where(s22 >= n_invalid_left * hop22, y22, 0.0)
        frames = dsp.frame_signal(y22, WIN, hop22, "constant")[:T]
    else:
        frames = dsp.frame_signal(y_zero, WIN, hop_length, "constant")
    # frames before the track start (slab 0's synthetic left halo) are
    # invalid: unvoiced, and their onset flux zero
    idx = torch.arange(T, device=y.device)
    out["onset_env"] = torch.where(idx >= n_invalid_left + 1,
                                   out["onset_env"], 0.0)
    out.update(_onset_backfill(
        _neural_pitch(params, frames, valid=idx >= n_invalid_left),
        out["onset_env"], sample_rate / hop_length, env_max=onset_ref))
    return _pack(out, _V1_ROWS, include_mel)


def run_analyze_neural_streamed(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params: Optional[PitchNet] = None,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = False,
    slab_frames: int = 16384,
    halo_frames: int = 16,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Bounded-memory streamed neural analyze for multi-minute tracks.

    Every stage is frame-local (window 2048, rake run-length <= 3 frames,
    cents median +-2, onset backfill bounded by the frame rate), so slabs
    with enough halo reproduce the fused program except for the dB
    reference, which pass 1 recovers as the track-global mel peak (the
    int16 slabs are uploaded once and stay on the device between passes).
    The whole track is quantized with ONE scale, so the rows equal the
    fused program's at transport="int16".  ``halo_frames`` is a floor: the
    halo grows with the frame rate so the backfill's ~0.14 s anchor window
    (plus its flux and mel lookback) fits.  Other rates resample once on
    the host and need an integral 22 050 Hz hop.  ``params``: a PitchNet
    on ``device`` (default: the committed checkpoint)."""
    device = resolve_device(device)
    if params is None:
        params = default_params(device)
    fps = sr / hop_length
    # the widest frame dependency is the onset backfill: k = round(0.14 fps)
    # frames back to an anchor, one more for its flux, one for the mel
    # frame; +4 also covers the cents median +-2 and rake run-length <= 3
    halo_frames = max(halo_frames, int(round(0.14 * fps)) + 4)
    true_frames = 1 + len(y) // hop_length
    if sr == SR_NATIVE:
        hop22 = 0
    else:
        num = hop_length * SR_NATIVE
        if num % sr != 0:
            raise ValueError(
                f"streamed neural analysis needs an integral 22.05 kHz hop "
                f"(sr={sr}, hop={hop_length}); resample the audio first")
        hop22 = num // sr
        from aegis_tpu_torch.io.audio import resample

        y22 = resample(np.asarray(y, np.float32), sr, SR_NATIVE)
        need22 = true_frames * hop22 + WIN
        y22 = np.pad(y22, (0, max(need22 - len(y22), 0)))

    # the fused program frames the bucket-padded signal: mel framing
    # reflects past the bucket's end, and its dB and onset references max
    # over the padded grid of T_pad frames, so the slab grid covers T_pad
    B_len = bucket_length(len(y))
    T_pad = 1 + B_len // hop_length

    S, H = slab_frames, halo_frames
    n_slabs = -(-T_pad // S)
    ext_len = (S + 2 * H) * hop_length  # samples per extended slab
    y16_full, scale = quantize_pcm16(np.asarray(y, np.float32))
    if hop22:
        y22_16_full, scale22 = quantize_pcm16(np.asarray(y22))
        ext22_len = (S + 2 * H) * hop22

    def slab16(full, a, length, bucket_len=None):
        lo, hi = max(a, 0), min(a + length, len(full))
        out = np.zeros(length, np.int16)
        if hi > lo:
            out[lo - a: hi - a] = full[lo:hi]
        if a < 0:
            # the track start reflected into the leading halo (np.pad
            # 'reflect': x[1..p] reversed), as the fused mel framing sees it
            p = min(-a, len(full) - 1)
            out[-a - p: -a] = full[1:1 + p][::-1]
        if bucket_len is not None and a + length > bucket_len:
            # the fused mel framing reflects past the bucket's end: the
            # virtual sample at p >= bucket_len is padded[2 * bucket_len -
            # 2 - p], zero inside the bucket's zero band
            p = np.arange(max(a, bucket_len), a + length)
            q = 2 * bucket_len - 2 - p
            m = (q >= 0) & (q < len(full))
            out[p[m] - a] = full[q[m]]
        return upload(out, device)

    sc = torch.full((), scale, dtype=torch.float32, device=device)
    sc22 = torch.full((), scale22 if hop22 else 0.0, dtype=torch.float32,
                      device=device)

    # pass 1a: upload every slab once; the track-global mel peak over
    # interior frames, clamped to the fused grid [0, T_pad)
    slabs, peaks = [], []
    for k in range(n_slabs):
        a = (k * S - H) * hop_length
        s16 = slab16(y16_full, a, ext_len, bucket_len=B_len)
        s22 = (slab16(y22_16_full, (k * S - H) * hop22, ext22_len)
               if hop22 else None)
        slabs.append((s16, s22))
        peaks.append(_neural_mel_peak(s16, sc, sr, hop_length, n_fft, n_mels,
                                      keep_lo=H,
                                      keep_hi=H + min(S, T_pad - k * S)))
    ref = torch.max(torch.stack(peaks))

    # pass 1b: the track-global onset-flux maximum, with the global dB
    # reference
    onset_ref = torch.max(torch.stack([
        _neural_onset_max(s16, sc, ref, H if k == 0 else 0, sr, hop_length,
                          n_fft, n_mels, keep_lo=H,
                          keep_hi=H + min(S, T_pad - k * S))
        for k, (s16, _) in enumerate(slabs)]))

    # pass 2: every slab queued before any fetch; slabs past true_frames
    # only fed the reference maxima.  n_valid_right: the first slab sample
    # of the bucket-tail reflection, which the pitch and RMS paths see as
    # zeros
    handles = []
    with phase("aegis.neural_slabs"):
        for k, (s16, s22) in enumerate(slabs):
            if k * S >= true_frames:
                break
            a = (k * S - H) * hop_length
            handles.append(_neural_slab_program(
                s16, sc, s22 if s22 is not None else s16, sc22,
                rake_sensitivity, params, ref, onset_ref,
                H if k == 0 else 0, int(np.clip(B_len - a, 0, ext_len)),
                sr, hop_length, n_fft, n_mels, fetch_mel, hop22))
    parts = [h[H: H + S].cpu().numpy() for h in handles]
    buf = np.concatenate(parts)[:true_frames]
    return _unpack(buf, _V1_ROWS, n_mels if fetch_mel else 0)


# ------------------------------------------------------------- host entries


def dispatch_analyze_neural(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params: Optional[PitchNet] = None,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    transport: str = "int8",
    device="cuda",
):
    """Async half of run_analyze_neural (mirrors
    core.analyze.dispatch_analyze): quantize, upload, queue the fused
    neural program on ``device`` and return an opaque handle WITHOUT
    waiting for the device, so a folder sweep can put every track in flight
    before fetching any.  Resolve with fetch_analyze_neural(handle)."""
    check_transport(transport, NEURAL_TRANSPORTS)
    device = resolve_device(device)
    if params is None:
        params = default_params(device)

    true_frames = 1 + len(y) // hop_length
    y_pad = pad_to_bucket(np.asarray(y, np.float32))
    y_q, s = ingest(y_pad, transport, device).upload(device)
    rows = _FIN_ROWS if financial else _V1_ROWS

    with phase("aegis.neural_program"):
        if sr == SR_NATIVE:
            if financial:
                packed = analyze_neural_financial_packed(
                    y_q, s, rake_sensitivity, params, sr, hop_length, n_fft,
                    n_mels, fetch_mel, use_guitar_filters)
            else:
                packed = analyze_neural_program_packed(
                    y_q, s, rake_sensitivity, params, sr, hop_length, n_fft,
                    n_mels, fetch_mel)
        else:
            from aegis_tpu_torch.io.audio import resample

            y22 = resample(np.asarray(y, np.float32), sr, SR_NATIVE)
            num = hop_length * SR_NATIVE
            uniform = num % sr == 0
            hop22 = num // sr if uniform else 0
            # pad so the pitch framing covers every original-grid frame
            T_pad = 1 + len(y_pad) // hop_length
            need = (T_pad * (hop22 or int(np.ceil(num / sr)))) + WIN
            y22_pad = np.pad(y22, (0, max(need - len(y22), 0)))
            y22_q, s22 = ingest(y22_pad, transport, device).upload(device)
            if uniform:
                centers = None
            else:
                # window start in the WIN//2-padded y22 = the rounded centre
                c = np.round(np.arange(T_pad) * num / sr).astype(np.int32)
                centers = upload(c, device).to(torch.int64)
            args = (y_q, s, y22_q, s22, centers, rake_sensitivity, params, sr,
                    hop_length, n_fft, n_mels, fetch_mel)
            if financial:
                packed = analyze_neural_financial_dual(
                    *args, use_guitar_filters, hop22)
            else:
                packed = analyze_neural_program_dual(*args, hop22)
    return packed, rows, true_frames, (n_mels if fetch_mel else 0)


def fetch_analyze_neural(handle) -> Dict[str, np.ndarray]:
    """Blocking half: copy the packed buffer to the host and unpack it."""
    packed, rows, true_frames, n_mels = handle
    return _unpack(packed[:true_frames].cpu().numpy(), rows, n_mels)


def run_analyze_neural(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params: Optional[PitchNet] = None,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    transport: str = "int8",
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Host wrapper mirroring core.analyze.run_analyze for the neural
    backend.  The non-pitch rows always use the caller's (sr, hop) frame
    grid; only the pitch head sees a 22 050 Hz resample, aligned frame by
    frame.  financial=True appends the guitar-filter / trend tail
    (_FIN_ROWS).  transport: "int8" (default; featurize() standardizes
    every window, so the net is gain-invariant), "int16" (what the streamed
    mode ships: its rows equal these at int16) or "float32"."""
    return fetch_analyze_neural(dispatch_analyze_neural(
        y, sr, hop_length, params, rake_sensitivity, n_fft, n_mels,
        fetch_mel, financial, use_guitar_filters, transport, device))


def run_analyze_neural_batch(
    ys: np.ndarray,
    sr: int,
    hop_length: int,
    params: Optional[PitchNet] = None,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = False,
    financial: bool = False,
    use_guitar_filters: bool = True,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Data-parallel PitchNet inference of a (B, n_samples) batch.

    The tracks split over every rank of the ``mesh``, its (data, time)
    grid flattened (PitchNet rows are frame-local and the net is small, so
    there is nothing to time-tile); the net is replicated and the only
    collective is the all-gather of the packed output, so every rank
    returns the whole batch.  In an initialized world with no mesh, every
    rank on the data axis, as the JAX package's default.  Each rank runs
    the fused native program (``_neural_native_rows``, + financial_tail)
    track by track.  Output schema matches engine.turbo.run_analyze_batch:
    _V1_ROWS (or _FIN_ROWS with financial=True) batched on axis 0.

    Native rate (22.05 kHz) only: other rates use the per-track dual-rate
    programs (dispatch_analyze_neural).  Tracks quantize per-track int16
    (core.analyze.quantize_tracks); silent filler tracks pad B to a
    multiple of the world and are dropped on fetch."""
    if sr != SR_NATIVE:
        raise ValueError(
            f"run_analyze_neural_batch is native-rate ({SR_NATIVE}) only; "
            f"got sr={sr} — dispatch the dual-rate per-track programs "
            "instead (dispatch_analyze_neural)")
    ys2 = np.asarray(ys, np.float32)
    if ys2.ndim != 2:
        raise ValueError(f"expected a (B, n_samples) batch, got {ys2.shape}")
    mesh, device = resolve_mesh(mesh, device, time_only=False)
    m = mesh or SOLO
    if params is None:
        params = default_params(device)

    B = ys2.shape[0]
    true_frames = 1 + ys2.shape[1] // hop_length
    n_samp = bucket_length(ys2.shape[1])
    # silent fillers (zeros, scale 1) shard-align the batch; dropped on fetch
    fill = [np.zeros(0, np.float32)] * ((-B) % m.world)
    y16, scales = quantize_tracks(list(ys2) + fill, n_samp)
    per = len(y16) // m.world
    mine = slice(m.rank * per, (m.rank + 1) * per)
    y_dev, s_dev = upload(y16[mine], device), upload(scales[mine], device)

    rows = _FIN_ROWS if financial else _V1_ROWS
    audio = AudioConfig(sample_rate=sr, hop_length=hop_length, n_fft=n_fft,
                        n_mels=n_mels)
    packed = []
    with phase("aegis.neural_batch"):
        for i in range(per):
            out = _neural_native_rows(y_dev[i], s_dev[i], rake_sensitivity,
                                      params, sr, hop_length, n_fft, n_mels)
            if financial:
                out = financial_tail(out, audio, use_guitar_filters)
            packed.append(_pack(out, rows, fetch_mel))
        local = torch.stack(packed)
    buf = torch.cat(m.gather_world(local)).cpu().numpy()[:B, :true_frames]
    return _unpack(buf, rows, n_mels if fetch_mel else 0)


# ---------------------------------------------------------------- training
#
# Counterpart of the JAX package's flax / optax trainer.  The loop lives in
# models/train.py; everything a step runs is here, on the device of the
# net and the clip bank, with its random state in an explicit
# torch.Generator on that device.


def init_params(seed: int = 0, hidden: Tuple[int, ...] = HIDDEN,
                device="cuda") -> PitchNet:
    """A fresh ``PitchNet`` on ``device`` with flax ``Dense``'s default
    init, not ``nn.Linear``'s: each weight from a normal truncated at two
    of its sigma = sqrt(1 / fan_in) / 0.87962566 (so its std is
    sqrt(1 / fan_in)), each bias zero.  Drawn from a generator on
    ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = PitchNet(hidden).to(device)
    with torch.no_grad():
        for layer in (*net.trunk, net.pitch, net.voiced):
            sigma = float(np.sqrt(1.0 / layer.in_features)) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, 0.0, sigma, -2.0 * sigma,
                                  2.0 * sigma, generator=gen)
            layer.bias.zero_()
    return net


def params_to_numpy(net: PitchNet) -> Dict:
    """The inverse of ``params_from_numpy``: the flax tree
    ``{"Dense_k": {"kernel": W.T, "bias": b}}`` of float32 NumPy arrays."""
    layers = (*net.trunk, net.pitch, net.voiced)
    return {f"Dense_{k}": {
        "kernel": layer.weight.detach().cpu().numpy().T.copy(),
        "bias": layer.bias.detach().cpu().numpy().copy()}
        for k, layer in enumerate(layers)}


def pitch_target(f0_hz: torch.Tensor, voiced: torch.Tensor) -> torch.Tensor:
    """Gaussian-blurred one-hot over the cents grid (sigma ~30 cents);
    uniform for unvoiced frames (they carry no pitch loss anyway).  The
    divisions by constants are products with their float32 reciprocals,
    as XLA compiles the JAX trainer's (ROADMAP "Bit-level traps")."""
    ratio = torch.clamp_min(f0_hz, 1e-3) * np.float32(1.0 / FMIN_HZ)
    cents = 1200.0 * torch.log2(ratio)
    centers = torch.from_numpy(bin_centers_cents()).to(f0_hz.device)
    d = (centers[None, :] - cents[:, None]) * np.float32(
        1.0 / (1.2 * CENTS_PER_BIN))
    g = torch.exp(-0.5 * d * d)
    g = g / (g.sum(-1, keepdim=True) + 1e-9)
    uni = torch.full((1, N_BINS), 1.0 / N_BINS, device=f0_hz.device)
    return torch.where(voiced[:, None], g, uni)


def _loss_terms(net: PitchNet, windows: torch.Tensor, f0_hz: torch.Tensor,
                voiced: torch.Tensor, label_w: Optional[torch.Tensor] = None):
    """The four sums of ``loss_fn``: (sum ce * pw, sum pw, sum vce * w,
    sum w)."""
    with torch.no_grad():
        feats = featurize(windows)
    logits, vlogit = net(feats)
    target = pitch_target(f0_hz, voiced)
    ce = -(target * torch.log_softmax(logits, dim=-1)).sum(-1)  # (B,)
    vmask = voiced.to(torch.float32)
    w = torch.ones_like(vmask) if label_w is None else label_w
    pw = vmask * w
    vce = F.binary_cross_entropy_with_logits(vlogit, vmask, reduction="none")
    return (ce * pw).sum(), pw.sum(), (vce * w).sum(), w.sum()


def loss_fn(net: PitchNet, windows: torch.Tensor, f0_hz: torch.Tensor,
            voiced: torch.Tensor,
            label_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross-entropy on the blurred cents target over voiced frames
    plus sigmoid cross-entropy on voicing (optax's two losses), each a
    weighted mean.  ``label_w`` (B,) in [0, 1] down-weights ambiguous
    frames (decay boundaries, reverb tails; models/data.py builds it);
    None = all 1.  The features carry no gradient: only the net trains."""
    ce_pw, pw, vce_w, w = _loss_terms(net, windows, f0_hz, voiced, label_w)
    pitch_loss = ce_pw / (pw + 1e-6)
    voiced_loss = vce_w / (w + 1e-6)
    return pitch_loss + voiced_loss


def crop_batch(tracks16: torch.Tensor, scale: torch.Tensor,
               f0_hz: torch.Tensor, voiced: torch.Tensor, ci: torch.Tensor,
               off: torch.Tensor, label_w: Optional[torch.Tensor] = None):
    """The (clip ``ci``, sample offset ``off``) windows of the resident
    int16 bank, gathered on its device and scaled to float32; labels (and
    per-block loss weights, when given) read at the window centre."""
    from aegis_tpu_torch.models.data import LABEL_HOP

    idx = off[:, None] + torch.arange(WIN, device=off.device)[None, :]
    wins = tracks16[ci[:, None], idx].to(torch.float32) * scale[ci][:, None]
    lab = torch.clamp((off + WIN // 2) // LABEL_HOP, 0, f0_hz.shape[1] - 1)
    w = None if label_w is None else label_w[ci, lab]
    return wins, f0_hz[ci, lab], voiced[ci, lab], w


def sample_windows(gen: torch.Generator, tracks16: torch.Tensor,
                   scale: torch.Tensor, f0_hz: torch.Tensor,
                   voiced: torch.Tensor, batch: int,
                   label_w: Optional[torch.Tensor] = None):
    """Device-side batch sampler: random (clip, offset) crops of the
    resident bank (``crop_batch``).  35 % of the offsets come from the
    attack region, [0, min(WIN, L - WIN + 1)): onset frames (half window
    silence + pluck + early ringing) are the hardest voicing decisions and
    only ~2 % of uniformly drawn offsets; the rest from [0, L - WIN + 1).
    Upper bounds exclusive, as ``jax.random.randint``'s."""
    n, L = tracks16.shape
    dev = tracks16.device
    ci = torch.randint(0, n, (batch,), generator=gen, device=dev)
    off_uni = torch.randint(0, L - WIN + 1, (batch,), generator=gen,
                            device=dev)
    off_atk = torch.randint(0, min(WIN, L - WIN + 1), (batch,),
                            generator=gen, device=dev)
    atk = torch.rand((batch,), generator=gen, device=dev) < 0.35
    off = torch.where(atk, off_atk, off_uni)
    return crop_batch(tracks16, scale, f0_hz, voiced, ci, off, label_w)


def lr_schedule(steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, 3e-4, warmup_steps=min(100,
    steps // 10 + 1), decay_steps=steps, end_value=1e-5)`` as a function of
    optax's count (0 for the first update): a linear warmup from 0, then a
    cosine over ``decay_steps - warmup_steps`` down to the end value.  In
    float32 and optax's own terms (the warmup is ``(0 - peak) * (1 - i / W)
    + peak``), so step 1 runs at 2.999994e-06, not 3e-06."""
    f32 = np.float32
    peak, end = f32(3e-4), f32(1e-5)
    warmup = min(100, steps // 10 + 1)
    cos_steps = steps - warmup
    alpha = end / peak

    def lr(i: int) -> float:
        if i < warmup:
            return float(-peak * (f32(1.0) - f32(i) / f32(warmup)) + peak)
        k = min(i - warmup, cos_steps)
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * f32(k)
                                               / f32(cos_steps)))
        return float(peak * ((f32(1.0) - alpha) * cosine + alpha))

    return lr


def init_train_state(seed: int = 0, hidden: Tuple[int, ...] = HIDDEN,
                     lr=3e-4, device="cuda"):
    """(net, optimizer): ``init_params`` and optax.adamw's update as
    ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8, weight decay
    1e-5).  ``lr`` a float or a schedule of the step index; ``train_on_batch``
    sets the group's rate before each step."""
    net = init_params(seed, hidden, device)
    first = lr(0) if callable(lr) else lr
    opt = torch.optim.AdamW(net.parameters(), lr=first, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-5)
    return net, opt


def train_on_batch(net: PitchNet, opt: torch.optim.Optimizer, lr: float,
                   wins: torch.Tensor, f0_hz: torch.Tensor,
                   voiced: torch.Tensor,
                   label_w: Optional[torch.Tensor] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One AdamW step at rate ``lr`` on one batch of windows; the loss
    before the step as a 0-d tensor on the device (no host sync).

    On a ``mesh`` the batch is the GLOBAL one and data-parallel over every
    rank (the flattened (data, time) grid, as the JAX step's
    ``with_sharding_constraint``): each rank keeps its slice.  The loss is
    a ratio of global sums, so the two denominators are summed over the
    ranks first (they carry no gradient) and each rank backpropagates its
    own numerators over them; the flattened gradients and the loss terms
    then add in rank order, and every rank applies the same AdamW step, so
    the replicas stay bitwise equal."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    if mesh is None:
        loss = loss_fn(net, wins, f0_hz, voiced, label_w)
        loss.backward()
    else:
        loss = _data_parallel_backward(net, mesh, wins, f0_hz, voiced,
                                       label_w)
    opt.step()
    return loss.detach()


def _data_parallel_backward(net: PitchNet, mesh: Mesh, wins, f0_hz, voiced,
                            label_w) -> torch.Tensor:
    n = wins.shape[0]
    if n % mesh.world:
        raise ValueError(f"batch {n} does not divide over {mesh.world} ranks")
    per = n // mesh.world
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    ce_pw, pw, vce_w, w = _loss_terms(
        net, wins[sl], f0_hz[sl], voiced[sl],
        None if label_w is None else label_w[sl])
    dens = mesh.psum_world(torch.stack([pw, w]).detach())
    loss = ce_pw / (dens[0] + 1e-6) + vce_w / (dens[1] + 1e-6)
    loss.backward()
    params = list(net.parameters())
    total = mesh.psum_world(torch.cat([p.grad.reshape(-1) for p in params]
                                      + [loss.detach().reshape(1)]))
    offset = 0
    for p in params:
        p.grad.copy_(total[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return total[-1]


def make_train_step(batch: int = 256, lr=3e-4, mesh: Optional[Mesh] = None):
    """The training step ``(net, opt, gen, step_idx, tracks16, scale, f0_hz,
    voiced, label_w) -> loss``: sample a batch of crops on the bank's
    device, featurize it, run the net, the loss, backward and the AdamW
    update at ``lr(step_idx)`` (or the constant ``lr``).  The loss comes
    back as a 0-d device tensor; nothing in the step waits for the card.
    On a ``mesh`` every rank draws the same global batch from its own
    generator, seeded alike, and keeps its slice (``train_on_batch``), so
    a world of N sees the crops of a world of one."""
    sched = lr if callable(lr) else (lambda i: lr)

    def step(net, opt, gen, step_idx, tracks16, scale, f0_hz, voiced,
             label_w=None):
        wins, f0b, vb, wb = sample_windows(gen, tracks16, scale, f0_hz,
                                           voiced, batch, label_w)
        return train_on_batch(net, opt, sched(step_idx), wins, f0b, vb, wb,
                              mesh)

    return step


def train_on_batches(tree: Dict, batches, lrs, mesh: Optional[Mesh] = None,
                     device="cuda"):
    """AdamW steps (``init_train_state``'s optimizer) from the flax tree
    ``tree`` on explicit NumPy batches ``(windows, f0_hz, voiced,
    label_w)``, one a rate of ``lrs``, on ``device`` or data-parallel over
    a ``mesh``; returns (the flax tree after the last step, the losses)."""
    from aegis_tpu_torch.utils.mesh import rank_device

    device = rank_device(mesh, device)
    net = pitchnet_from_numpy(tree, device)
    net.train()
    opt = torch.optim.AdamW(net.parameters(), lr=lrs[0], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-5)
    losses = []
    for (wins, f0, voiced, w), lr in zip(batches, lrs):
        loss = train_on_batch(
            net, opt, lr, upload(wins, device), upload(f0, device),
            upload(voiced, device), None if w is None else upload(w, device),
            mesh)
        losses.append(float(loss))
    return params_to_numpy(net), losses


def save_params(net: PitchNet, path: str,
                metrics: Optional[Dict] = None) -> str:
    """The JAX package's checkpoint layout: the flax tree as float16 under
    ``Dense_k/kernel`` and ``Dense_k/bias`` plus a ``__meta__`` JSON record
    (feature version, architecture, bin grid, the training metrics), with
    ``np.savez_compressed``; it loads in both packages' ``load_params``.
    Returns the path written (np.savez appends .npz to bare names)."""
    flat = {f"{layer}/{name}": np.asarray(v).astype(np.float16)
            for layer, d in params_to_numpy(net).items()
            for name, v in d.items()}
    meta = {"feature_version": FEATURE_VERSION, "win": WIN,
            "sr_native": SR_NATIVE, "n_bins": N_BINS,
            "cents_per_bin": CENTS_PER_BIN, "fmin_hz": FMIN_HZ,
            "hidden": list(HIDDEN), "metrics": metrics or {}}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()
    if not path.endswith(".npz"):
        path += ".npz"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **flat)
    return path
