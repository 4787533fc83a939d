"""Dense decoder layers and seeded fp parameters."""
