"""CLI entry points (reference ``cmd/``)."""
