"""The continual-learning trainer: the per-task runner and the task loop."""
