"""Streamlit application layer of the port.

The JAX package's eleven app modules under the same names: the Tuning
Center (the main v1 UI), Tuner Pro, the Live Monitor, the financial batch
and realtime apps, the stem lab, the multi-engine MIDI sandbox, and the
collector studio and intelligence dashboard.  Each app's device work runs
on the card (``main(device="cuda")``); no app falls back to the CPU.

streamlit is an optional dependency: each app imports it inside ``main``
through ``common.require_streamlit`` with a clear message, and every
engine call lives in the port's core packages, so the apps are thin views.

Run:  streamlit run aegis_tpu_torch/apps/<app>.py   (e.g. tuning_center.py)
"""
