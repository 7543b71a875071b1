"""The paper's benchmark configurations (copied from ``repro.configs``)."""
