"""The LM substrate's steps and the token sketch that rides along them."""
