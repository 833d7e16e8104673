"""Device helpers for the port (`utils.devices`)."""
