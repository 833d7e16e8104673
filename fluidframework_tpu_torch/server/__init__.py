"""Server-side datapaths of the port (the summary service's fold)."""
