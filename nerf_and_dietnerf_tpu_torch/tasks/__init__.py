"""Run orchestration: the config-driven task dispatcher and its tasks."""
