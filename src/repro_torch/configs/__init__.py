"""Architecture and run configurations (copies of ``repro.configs``)."""
