"""Evaluation: teacher-forced scoring and perplexity."""
