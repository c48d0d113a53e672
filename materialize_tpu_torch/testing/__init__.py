"""Test tooling of the port: the SLT runner and the chaos harness."""
