"""The serving front door: admission parsing (the HTTP server is not
ported yet)."""
