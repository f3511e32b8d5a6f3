"""Cost accounting of the port's programs."""
