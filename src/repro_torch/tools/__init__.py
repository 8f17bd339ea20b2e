"""Tools of the port: the dry-run's roofline and cost counter."""
