from aegis_tpu_torch.harmony.key import HarmonicAnalyzer, apply_harmonic_filter  # noqa: F401
