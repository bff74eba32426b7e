"""The LM substrate's models: the dense GQA family so far (``model.py``)."""
