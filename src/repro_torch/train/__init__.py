"""Single-device training (the port of ``repro.train``)."""
