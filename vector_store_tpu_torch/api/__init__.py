"""REST service layer (ANN surface)."""
