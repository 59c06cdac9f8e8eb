"""Synthetic guitar-like training data for PitchNet (a copy of
``aegis_tpu/models/data.py``; the port's trainer, ``models/train.py``,
uploads its int16 bank to the card once).

Fully vectorized NumPy synthesis (no per-sample Python loops) of short
single-gesture clips with exact per-sample f0 ground truth:

  * voiced clips — additive plucked-tone model: 6 partials with random
    spectral rolloff and slight inharmonicity, fast attack + exponential
    decay, optional vibrato (sine FM) and pitch chirp (slides/bends), a
    short broadband pluck transient, and a random noise floor.  This is the
    same family of signals the reference's own oracle uses
    (generate_test_signal.py:5-53 Karplus-Strong + rake bursts) but with a
    continuous f0 label track.
  * unvoiced clips — white noise, decaying broadband "rake" bursts, and
    near-silence (which after int16 transport quantization is exactly what
    the inference path sees).

Clips are returned int16-quantized per clip — identical to the engines'
device transport convention (core/analyze.py::quantize_pcm16) so training
and inference see the same quantization noise.

A fraction of the voiced clips pass through the framework's own effect
chain family (synth/effects.py: tanh distortion, diffuse-IR reverb, LFO
chorus — the presets the robustness gate replays), so effect robustness is
in the training distribution by construction instead of by luck.  Each clip
also carries a per-label-block loss weight ``label_w``: 0 around every
voiced->unvoiced transition (the decay boundary is genuinely ambiguous at
window scale — supervising it is label noise) and 0 for everything after
the voiced end of a reverberant clip (the tail keeps ringing past the
pre-effect label).  Onset (unvoiced->voiced) edges stay fully supervised —
onset timing is what the event F1 tolerance actually measures.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LABEL_HOP = 128  # f0/voicing ground truth every 128 samples

# Decay-boundary ambiguity radius in label blocks.  A window centered
# within ~half a window (16 blocks) of a voiced->unvoiced transition
# genuinely contains both tone and silence; masking that whole span,
# however, leaves the voicing head so unconstrained near note edges that
# onsets trigger late (measured: a radius of 8 delayed a soft post-rake
# attack by ~70 ms, past the event-F1 tolerance).  4 blocks masks only the
# truly contradictory center region and keeps the edges supervised.
DECAY_AMBIG_BLOCKS = 4

# One-sided pre-onset mask radius: half a PitchNet window (1024 samples)
# in label blocks.  A window whose center sits up to this far BEFORE an
# attack already contains the attack in its right half; punishing a voiced
# call there teaches the net to fire late (center-past-attack semantics),
# which measured ~70-90 ms of onset lag vs pYIN — the event-F1 killer.
# Removing supervision on ONLY the unvoiced side of each rising edge lets
# the head fire as early as the evidence allows (the old eager behavior)
# while the voiced side still demands detection by window center.
ONSET_AMBIG_BLOCKS = 8

# Supervision weight across the pre-onset span (window centers before the
# attack whose right half already contains it): voiced with the UPCOMING
# note's pitch.  See the label_w construction in make_clips for the
# measured failure this replaces (junk-pitch rake events on retrains).
ONSET_PRE_W = 0.3


def _fx_augment(sig: np.ndarray, rng, sr: int):
    """Apply a random pitch-preserving effect chain from the family the
    robustness gate replays (synth/effects.py semantics, NumPy): tanh
    distortion, diffuse-IR reverb, LFO chorus.  Returns (wet, rings) where
    ``rings`` marks reverb tails that outlive the pre-effect voicing label.
    Delay is excluded: its echoes re-onset the old pitch, which has no
    honest frame label."""
    from scipy.signal import fftconvolve

    from aegis_tpu_torch.synth.effects import _reverb_ir

    rings = False
    kind = int(rng.integers(0, 4))  # 0 dist, 1 reverb, 2 chorus, 3 dist+rev
    if kind in (0, 3):
        drive = float(rng.uniform(0.2, 0.9))
        sig = np.tanh(sig * (1.0 + 19.0 * drive))
        sig = sig / max(float(np.abs(sig).max()), 1e-6)
    if kind in (1, 3):
        room = float(rng.uniform(0.2, 0.7))
        ir = _reverb_ir(room, sr)
        wet = fftconvolve(sig, ir)[:len(sig)].astype(np.float32)
        wet_ratio = room * 0.6
        sig = (1.0 - wet_ratio * 0.5) * sig + wet_ratio * wet
        rings = True
    if kind == 2:
        depth = float(rng.uniform(0.001, 0.004))
        rate = float(rng.uniform(0.8, 3.0))
        n = len(sig)
        t = np.arange(n, dtype=np.float64)
        idx = np.clip(t - (int(0.007 * sr)
                           + depth * sr * np.sin(2 * np.pi * rate * t / sr)),
                      0, n - 1)
        lo = np.floor(idx).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        fr = (idx - lo).astype(np.float32)
        sig = 0.7 * sig + 0.3 * (sig[lo] * (1 - fr) + sig[hi] * fr)
    return sig.astype(np.float32), rings


def make_clips(
    n: int,
    clip_len: int = 16384,
    sr: int = 22050,
    seed: int = 0,
    voiced_frac: float = 0.85,
    fmin: float = 80.0,
    fmax: float = 1000.0,
    ks_frac: float = 0.35,
    fx_frac: float = 0.3,
    low_every: int = 4,
    weakfund_every: int = 3,
    tilt_frac: float = 0.15,
) -> Dict[str, np.ndarray]:
    """Returns {tracks (n, L) int16, scale (n,) f32,
    f0_hz (n, L//LABEL_HOP) f32 (0 where unvoiced),
    voiced (n, L//LABEL_HOP) bool,
    label_w (n, L//LABEL_HOP) f32 per-block loss weight}.

    ks_frac of the voiced clips are Karplus-Strong plucked strings (the
    waveform family the product's test tracks and real guitar attacks live
    in: a full harmonic series with inharmonic attack noise) — additive
    tones alone left the net octave-confused on rich spectra (measured:
    34% of frames >100 cents off on the KS gating clip)."""
    rng = np.random.default_rng(seed)
    nv = int(round(n * voiced_frac))
    nu = n - nv
    n_ks = int(round(nv * ks_frac))
    L = clip_len
    t = (np.arange(L) / sr).astype(np.float32)

    y = np.zeros((n, L), np.float32)
    f0_full = np.zeros((n, L), np.float32)
    voiced_full = np.zeros((n, L), bool)

    # ---- Karplus-Strong plucked strings (per clip; lfilter is C-fast) ----
    from scipy import signal as _signal

    for i in range(n_ks):
        f_want = float(np.exp(rng.uniform(np.log(fmin), np.log(fmax))))
        if low_every and i % low_every == low_every - 1:
            # low-octave emphasis: log-uniform [fmin, fmax] leaves only ~8%
            # of clips below 98 Hz, and the committed net octave-flipped on
            # 2/30 low-G KS excitations (5.7% of voiced frames at 98 Hz,
            # measured 2026-08-18) — the bench track's three residual event
            # errors.  A quarter of the plucks resample from the bottom
            # ~1.1 octaves so the net's low edge is trained, not just
            # covered.
            f_want = float(np.exp(rng.uniform(np.log(fmin),
                                              np.log(2.2 * fmin))))
        # half the plucks are synthesized at 2x rate and decimated — the
        # production 44.1 kHz path resamples to 22.05 kHz, and the
        # anti-alias filter halves the broadband attack peak (a spectrum
        # the net must also recognize as a note onset)
        hi_rate = i % 2 == 1
        sr_syn = 2 * sr if hi_rate else sr
        L_syn = 2 * L if hi_rate else L
        N = max(int(sr_syn / f_want), 2)
        f_true = sr_syn / (N + 0.5)  # the averaging loop adds half a sample
        decay = float(rng.uniform(0.994, 0.999))
        if hi_rate:
            decay = decay ** 0.5  # same per-second ring time at 2x rate
        x = np.zeros(L_syn, np.float32)
        x[:min(N, L_syn)] = rng.uniform(-1, 1, min(N, L_syn))
        if weakfund_every and i % weakfund_every == weakfund_every - 1:
            # weak-fundamental pluck: first-difference the excitation
            # (+6 dB/oct tilt), so harmonic 2 dominates the attack spectrum
            # — the octave-error timbre.  The label stays the loop period:
            # pitch is periodicity, not the loudest partial.
            ne = min(N, L_syn)
            x[:ne] = np.diff(x[:ne], prepend=np.float32(0.0))
        a = np.zeros(N + 2)
        a[0] = 1.0
        a[N] = a[N + 1] = -0.5 * decay
        sig = _signal.lfilter([1.0], a, x).astype(np.float32)
        if hi_rate:
            sig = _signal.resample_poly(sig, 1, 2).astype(np.float32)[:L]
        peak = np.abs(sig).max() + 1e-9
        amp_out = float(rng.uniform(0.15, 1.0))
        sig = sig / peak * amp_out
        noise_amp = float(10.0 ** (rng.uniform(-60.0, -26.0) / 20.0))
        sig += noise_amp * rng.standard_normal(L).astype(np.float32)
        # voiced while the string rings above the noise floor (1.5x: pYIN
        # tracks the decay tail well below an equal-power crossover, and
        # cutting the label early truncated event ends)
        # tail-pad so any clip_len works, not only LABEL_HOP multiples
        n_blk = -(-L // LABEL_HOP)
        sig_pad = np.pad(sig, (0, n_blk * LABEL_HOP - L), mode="edge")
        blk = np.sqrt(np.mean(
            sig_pad.reshape(-1, LABEL_HOP) ** 2, axis=1))
        vm = np.repeat(blk > 1.5 * noise_amp, LABEL_HOP)[:L]
        y[i] = sig
        f0_full[i] = f_true
        voiced_full[i] = vm

    # ---- additive voiced clips (blocks bound the (block, L) temporaries) -
    done = n_ks
    while done < nv:
        b = min(512, nv - done)
        base = np.exp(rng.uniform(np.log(fmin), np.log(fmax), (b, 1))).astype(
            np.float32)
        has_vib = rng.random((b, 1)) < 0.5
        vib_depth = rng.uniform(5.0, 60.0, (b, 1)) * has_vib
        vib_rate = rng.uniform(3.5, 7.5, (b, 1))
        vib_phase = rng.uniform(0, 2 * np.pi, (b, 1))
        has_chirp = rng.random((b, 1)) < 0.4
        chirp = rng.uniform(-400.0, 400.0, (b, 1)) * has_chirp  # cents/clip
        # note transitions: ~25% of clips step to a new pitch mid-clip, so
        # boundary windows (two pitches inside one window) are in
        # distribution — without them the net emits junk-pitch blips at
        # note changes (seen as spurious 2-frame events on the scale clip)
        has_step = rng.random((b, 1)) < 0.25
        t_step = rng.uniform(0.25, 0.75, (b, 1)) * t[-1]
        step = (rng.uniform(100.0, 1200.0, (b, 1))
                * np.sign(rng.standard_normal((b, 1))) * has_step)
        # keep the stepped pitch inside [fmin, fmax] (and the label grid)
        step = np.clip(step, 1200.0 * np.log2(fmin / base),
                       1200.0 * np.log2(fmax / base))
        cents = (vib_depth * np.sin(2 * np.pi * vib_rate * t + vib_phase)
                 + chirp * (t / t[-1])
                 + step * (t >= t_step)).astype(np.float32)
        f0 = base * np.exp2(cents / 1200.0)  # (b, L)
        # vibrato/chirp stack on top of the clipped step, so keep the final
        # pitch inside the label grid (PitchNet's 192 25-cent bins span
        # ~77.8-1226 Hz); clip BEFORE phase integration so audio == label
        from aegis_tpu_torch.models.pitchnet import (CENTS_PER_BIN, FMIN_HZ,
                                                     N_BINS)

        f0 = np.clip(f0, FMIN_HZ * 2.0 ** (CENTS_PER_BIN / 1200.0),
                     FMIN_HZ * 2.0 ** ((N_BINS - 2) * CENTS_PER_BIN
                                       / 1200.0)).astype(np.float32)
        phase = (2 * np.pi / sr) * np.cumsum(f0, axis=1)

        alpha = rng.uniform(0.5, 1.8, (b, 1))
        # ~15% rising spectral tilt (partials LOUDER than the fundamental):
        # the missing-fundamental timbre that teaches the pitch head
        # periodicity over peak-picking; without it, confidently-voiced
        # octave-up errors survive the cents median on low plucks
        tilt_up = rng.random((b, 1)) < tilt_frac
        alpha = np.where(tilt_up, rng.uniform(-0.7, -0.1, (b, 1)), alpha)
        inharm = rng.uniform(0.0, 2e-4, (b, 1))
        # spectral-shape diversity: ~15% pure sines (the scale/benchmark
        # clips are plain sinusoids), otherwise random partial dropout —
        # without this the net treats single-peak spectra as unvoiced
        pure = rng.random((b, 1)) < 0.15
        sig = np.zeros((b, L), np.float32)
        for k in range(1, 7):
            amp = (k ** -alpha) * rng.uniform(0.4, 1.0, (b, 1))
            if k > 1:
                amp = amp * (rng.random((b, 1)) < 0.85) * (~pure)
            stretch = k * np.sqrt(1.0 + inharm * k * k)
            # partials above Nyquist alias; drop them (clip-wise, f0 is
            # within a factor ~1.26 of base so base is a safe proxy)
            amp = np.where(base * stretch < 0.48 * sr, amp, 0.0)
            ph0 = rng.uniform(0, 2 * np.pi, (b, 1))
            sig += (amp * np.sin(stretch * phase + ph0)).astype(np.float32)

        attack = rng.uniform(0.002, 0.012, (b, 1)).astype(np.float32)
        # tilted (missing-fundamental) clips take a SOFT attack and no
        # pluck transient: their role is the octave cue (periodicity over
        # peak-picking).  Pairing them with a bright noise attack taught
        # the voicing head that broadband bursts are voiced onsets — the
        # retrained nets transcribed the KS track's RAKE as a 3-frame
        # 131 Hz note (measured 2026-08-18, 5/5 retrains failing the kst
        # truth gate until this decoupling).
        attack = np.where(tilt_up, rng.uniform(0.02, 0.05, (b, 1)),
                          attack).astype(np.float32)
        tau = rng.uniform(0.15, 1.6, (b, 1)).astype(np.float32)
        env = (np.minimum(t / attack, 1.0)
               * np.exp(-np.maximum(t - attack, 0.0) / tau)).astype(np.float32)
        sig *= env

        # pluck transient: 4 ms of broadband noise at the attack
        n_pluck = max(int(0.004 * sr), 8)
        pluck = rng.standard_normal((b, n_pluck)).astype(np.float32)
        pluck *= rng.uniform(0.1, 0.5, (b, 1)) * np.linspace(1, 0, n_pluck)
        pluck *= ~tilt_up
        sig[:, :n_pluck] += pluck

        peak = np.max(np.abs(sig), axis=1, keepdims=True) + 1e-9
        amp_out = rng.uniform(0.15, 1.0, (b, 1)).astype(np.float32)
        sig = sig / peak * amp_out

        noise_amp = (10.0 ** (rng.uniform(-70.0, -16.0, (b, 1)) / 20.0)
                     ).astype(np.float32)
        sig += noise_amp * rng.standard_normal((b, L)).astype(np.float32)

        # voiced while the tone stands clear of the noise floor (>= ~12 dB);
        # the attack (ramp + pluck burst) BELONGS to the note — labeling it
        # unvoiced taught the net to call plucks noise, which delayed every
        # onset by 4-7 frames (>50 ms F1 tolerance) on real attacks
        tone_level = amp_out * np.maximum(env, t < (attack + 0.02))
        vm = tone_level > 4.0 * noise_amp

        y[done:done + b] = sig
        f0_full[done:done + b] = f0
        voiced_full[done:done + b] = vm
        done += b

    # ---- unvoiced clips --------------------------------------------------
    if nu:
        kind = rng.integers(0, 3, nu)
        noise = rng.standard_normal((nu, L)).astype(np.float32)
        amp = rng.uniform(0.02, 0.8, (nu, 1)).astype(np.float32)
        un = noise * amp
        # decaying broadband "rake" bursts (reference vision.py semantics)
        burst_env = np.exp(-t / 0.03).astype(np.float32)
        un[kind == 1] *= burst_env
        # near-silence: amplitudes at or below 1-2 int16 LSBs
        un[kind == 2] = (noise[kind == 2]
                         * rng.uniform(1e-5, 1e-4, ((kind == 2).sum(), 1))
                         .astype(np.float32))
        y[nv:] = un

    # ---- random lead-ins on voiced clips ----------------------------------
    # every clip used to start AT the pluck, so no training window ever had
    # the inference-time onset shape (left half silence, right half attack);
    # shifting by up to one window puts those exact windows in distribution.
    # A third of the lead-ins are decaying broadband "rake" bursts instead
    # of silence: the product's canonical gesture is rake -> note attack
    # (tools/signal_gen.py), and a net that never saw noise-then-pluck
    # windows triggered voicing ~70 ms late on exactly those onsets.
    for i in range(nv):
        lead = int(rng.integers(0, 2048))
        if lead:
            y[i, lead:] = y[i, :-lead]
            y[i, :lead] = 0.0
            f0_full[i, lead:] = f0_full[i, :-lead]
            f0_full[i, :lead] = 0.0
            voiced_full[i, lead:] = voiced_full[i, :-lead]
            voiced_full[i, :lead] = False
            if lead > 64 and rng.random() < 0.33:
                burst = rng.standard_normal(lead).astype(np.float32)
                burst *= np.exp(-np.arange(lead, dtype=np.float32)
                                / (float(rng.uniform(0.01, 0.03)) * sr))
                peak_i = float(np.abs(y[i]).max())
                y[i, :lead] += burst * float(rng.uniform(0.2, 0.9)) * peak_i

    # ---- effect-chain augmentation on a fraction of voiced clips ----------
    # separate generator so the main stream's consumption (and therefore
    # every clip/label) is identical for any fx_frac — augmentation only
    # rewrites the selected waveforms
    rng_fx = np.random.default_rng(rng.integers(1 << 63))
    rings = np.zeros(n, bool)
    if fx_frac > 0.0 and nv:
        fx_idx = rng_fx.permutation(nv)[: int(round(nv * fx_frac))]
        for i in fx_idx:
            y[i], rings[i] = _fx_augment(y[i], rng_fx, sr)
            peak_i = float(np.abs(y[i]).max()) + 1e-9
            y[i] *= float(rng_fx.uniform(0.15, 1.0)) / peak_i

    # ---- int16 transport quantization (per clip, like quantize_pcm16) ---
    # Near-silent clips are NOT peak-normalized: at inference quantize_pcm16
    # scales by the whole track's peak, so quiet passages genuinely occupy
    # 1-2 LSBs with coarse staircase spectra — normalizing them here would
    # train the voicing head on smooth noise it never sees in production.
    peak = np.max(np.abs(y), axis=1)
    quiet = peak < 1e-3
    peak = np.where(quiet | (peak <= 0), 1.0, peak)
    scale = (peak / 32767.0).astype(np.float32)
    tracks = np.round(y / peak[:, None] * 32767.0).astype(np.int16)

    f0_lab = f0_full[:, ::LABEL_HOP].copy()
    v_lab = voiced_full[:, ::LABEL_HOP].copy()
    f0_lab[~v_lab] = 0.0

    # ---- per-block loss weights -------------------------------------------
    # zero around every voiced->unvoiced (decay) boundary: a window centered
    # there contains both tone and silence, so its voicing label is noise;
    # rising (onset) edges stay at weight 1 — onset timing is the product
    # metric.  Reverberant clips additionally zero everything after their
    # voiced end: the tail keeps ringing past the pre-effect label.
    label_w = np.ones_like(f0_lab, np.float32)
    fall = np.zeros_like(v_lab)
    fall[:, 1:] = v_lab[:, :-1] & ~v_lab[:, 1:]
    from scipy.ndimage import binary_dilation

    ambig = binary_dilation(
        fall, structure=np.ones((1, 2 * DECAY_AMBIG_BLOCKS + 1), bool))
    label_w[ambig] = 0.0
    # one-sided pre-onset span: blocks whose window already contains the
    # upcoming attack (see ONSET_AMBIG_BLOCKS)
    near_onset = np.zeros_like(v_lab)
    for s in range(1, ONSET_AMBIG_BLOCKS + 1):
        near_onset[:, :-s] |= v_lab[:, s:]
    pre = ~v_lab & near_onset
    label_w[pre] = 0.0
    # Leaving the pre-onset span fully UNSUPERVISED made post-rake behavior
    # a per-training-run coin flip: the canonical rake->pluck gesture lives
    # exactly here, and with zero weight on BOTH heads the net is free to
    # decode junk pitch (measured: retrained nets minted a spurious
    # 3-frame 131 Hz event on the KS track's rake in 8/8 runs across every
    # augmentation config, while the committed checkpoint was simply a
    # lucky draw).  Supervise the span with the UPCOMING note instead, at
    # gentle weight: a window whose right half contains the attack may
    # fire early (within the 50 ms F1 tolerance — window centers reach at
    # most half a window past the block), but when it does its pitch must
    # be the note's, so the event extractor merges it into the note
    # instead of minting a junk-pitch prefix event.  Voicing eagerness is
    # now trained, not left to initialization.
    f0_next = np.zeros_like(f0_lab)
    for s in range(1, ONSET_AMBIG_BLOCKS + 1):
        src_v = np.zeros_like(v_lab)
        src_v[:, :-s] = v_lab[:, s:]
        src_f = np.zeros_like(f0_lab)
        src_f[:, :-s] = f0_lab[:, s:]
        fill = pre & (f0_next == 0) & src_v & (src_f > 0)
        f0_next[fill] = src_f[fill]
    # decay ambiguity wins where the spans overlap (short inter-note gaps:
    # the window holds BOTH the dying previous note and the next attack —
    # genuinely contradictory, keep it unsupervised).  Grow the voiced
    # pre-span CONTIGUOUSLY backward from each rising edge and stop at the
    # first ambiguous block — a skipped-over block would leave a voiced
    # island with a synthetic fall edge in the labels.
    allowed = pre & (f0_next > 0) & ~ambig
    grow = v_lab.copy()
    sel = np.zeros_like(v_lab)
    for _ in range(ONSET_AMBIG_BLOCKS):
        nxt = np.zeros_like(v_lab)
        nxt[:, :-1] = grow[:, 1:]
        add = allowed & nxt & ~grow
        if not add.any():
            break
        grow |= add
        sel |= add
    f0_lab[sel] = f0_next[sel]
    v_lab[sel] = True
    label_w[sel] = ONSET_PRE_W
    if rings.any():
        past_end = ~np.maximum.accumulate(v_lab[rings][:, ::-1],
                                          axis=1)[:, ::-1]
        w_r = label_w[rings]
        w_r[past_end & ~v_lab[rings]] = 0.0
        label_w[rings] = w_r

    # shuffle so device batches mix voiced/unvoiced
    perm = rng.permutation(n)
    return {
        "tracks": tracks[perm],
        "scale": scale[perm],
        "f0_hz": f0_lab[perm],
        "voiced": v_lab[perm],
        "label_w": label_w[perm],
    }
