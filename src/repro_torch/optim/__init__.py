"""The optimizer of the LM substrate: AdamW with f32 master weights
(``adamw.py``) and int8 error-feedback gradient compression
(``compression.py``)."""
