"""Plain PyTorch and NumPy references that decide ``correct``.

They follow the published Improved SuDoRM-RF (arXiv:2103.02644) and the
recipes' semantics from the weights and inputs the harness made, and import
nothing of the program: whatever the program derives (folded norms, cast
copies, the kernel's parameter dict, the pool's index tables) is worked out
here again. Run them with TF32 off (``perfbench.core.fp32_strict``).
"""
