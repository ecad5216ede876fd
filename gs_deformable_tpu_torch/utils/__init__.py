"""Losses, learning-rate schedules and image metrics of the port."""
