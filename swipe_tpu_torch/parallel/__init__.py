"""Multi-device and multi-host execution: sharding, gathers, top-K merge."""
