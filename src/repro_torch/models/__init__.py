"""The paper's taggers as ``nn.Module`` and the dense decoder LM (specs,
layers, single-step decode), with their parameter specs."""
