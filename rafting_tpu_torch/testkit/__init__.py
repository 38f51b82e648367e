"""Test kit of the PyTorch port: nemesis schedules and invariant audits."""
