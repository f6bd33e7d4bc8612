"""Training data: the length-bucketed Tacotron batch loader."""
