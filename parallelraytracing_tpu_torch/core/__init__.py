"""Scene, camera and film on the host and the device."""
