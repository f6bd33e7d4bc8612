"""Inference: the end-to-end synthesizer."""
