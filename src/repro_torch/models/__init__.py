"""The paper's taggers as ``nn.Module`` and the LMs of every family (dense,
moe, ssm, hybrid, audio enc-dec, vlm: specs, layers, single-step decode),
with their parameter specs."""
