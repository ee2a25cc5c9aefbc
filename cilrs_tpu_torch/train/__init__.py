"""Evaluation steps and policy checkpoints."""
