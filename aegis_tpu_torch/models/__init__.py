"""Learned models of the port: PitchNet (``models/pitchnet.py``), the
spectrum-input pitch / voicing network behind ``pitch_backend="neural"``,
its trainer (``models/train.py``) and synthetic training clips
(``models/data.py``).  The neural backend runs the committed checkpoint
``models/weights/pitchnet_v1.npz``, a byte-for-byte copy of the JAX
package's; the trainer writes the same layout."""
