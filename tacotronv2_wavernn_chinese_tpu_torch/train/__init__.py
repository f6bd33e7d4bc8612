"""Tacotron-2 training: the train step and the training loop."""
