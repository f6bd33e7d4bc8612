"""Tacotron-2 and WaveRNN in PyTorch, as functions over params dicts."""
