from aegis_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
from aegis_tpu_torch.io.audio import load_audio, resample  # noqa: F401
