"""The LM stack (port of ``repro.nn``, dense family): parameters are nested
dicts of tensors as in the reference, layers are functions over them."""
