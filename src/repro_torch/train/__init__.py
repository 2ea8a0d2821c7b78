"""Training of the port: AdamW, the train step, gradient compression and
the training loop."""
