"""Building blocks of the port's models (NCHW nn.Modules)."""
