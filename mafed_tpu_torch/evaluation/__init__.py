"""Evaluation: greedy KV-cache decode, VQA-v2 metrics, the validation loop."""
