"""Plain fp32 references of the benchmark's models, in PyTorch with TF32
off, importing nothing of the port: a model is a function of a dict of
named tensors, its loss and gradients come from autograd, and the
optimizers are written out. ``common.Precision("fp8")`` puts every matrix
product's operands through fp8 (the control, one precision below the
configurations' bf16)."""
