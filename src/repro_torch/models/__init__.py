"""The LM substrate's models (``model.py``): the dense GQA, MLA (``mla.py``)
and MoE (``moe.py``) families."""
