"""Host-side input: the native JPEG decode + letterbox loader binding."""
