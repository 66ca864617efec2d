"""The paper's taggers as ``nn.Module`` and their parameter specs."""
