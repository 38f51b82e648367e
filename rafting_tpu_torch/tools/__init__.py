"""Operational CLI tools: standalone node runner, offline log checker."""
