"""The plain reference: the models' equations in plain PyTorch, computed
in float32 with TF32 off, from the weights and inputs the harness made.
It imports nothing of the program. ``Precision("fp8")`` is the control:
the same equations with every product's operands rounded to float8
e4m3 (a per-tensor scale), the step below the configurations' bf16."""
