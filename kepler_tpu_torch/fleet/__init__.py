"""Fleet path: wire frames and the device-resident window engines."""
