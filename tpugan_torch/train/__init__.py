"""Optimizers, replay buffer, input normalisation and loop plumbing."""
