"""Finetuning: optimizer and schedules, train state, retrieval and QA train steps."""
