"""Scene preprocessing tools, host-side."""
