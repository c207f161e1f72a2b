"""Run artifacts."""
