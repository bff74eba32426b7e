"""Space Saving summaries, the COMBINE operator and the exact oracle."""
