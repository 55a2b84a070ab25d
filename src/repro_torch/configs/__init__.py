"""Model configurations (a copy of ``repro.configs``; data only)."""
