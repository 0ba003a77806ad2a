"""One driver a kind of traffic: train, generate, prefill."""
