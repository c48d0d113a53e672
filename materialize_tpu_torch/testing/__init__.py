"""Test tooling of the port: the SLT runner."""
