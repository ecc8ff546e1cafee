"""The plain PyTorch reference of the check: float32, TF32 off, no kernel,
and nothing imported from the program."""
