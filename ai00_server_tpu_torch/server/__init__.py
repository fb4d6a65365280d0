"""HTTP server of the port (aiohttp)."""
