"""Synthesis: the ADSR synth, the effect chain, FluidSynth and stems."""
