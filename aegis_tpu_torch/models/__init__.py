"""Learned models of the port: PitchNet inference (``models/pitchnet.py``),
the spectrum-input pitch / voicing network behind ``pitch_backend="neural"``.
The trainer of the JAX package (``aegis_tpu/models/train.py``) is not
ported; the port runs the committed checkpoint
``models/weights/pitchnet_v1.npz``, a byte-for-byte copy of the JAX
package's."""
