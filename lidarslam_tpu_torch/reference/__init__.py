"""Plain float64 references that the port's stages are held to."""
