"""The plain fp32 reference: networks, schedule, algorithms."""
