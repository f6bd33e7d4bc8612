"""HTTP serving of exported artifacts."""
