"""Plain references, one module per configuration. Each works from the
inputs the harness hands to the program (the configuration and the
data arrays) and imports nothing of the program."""
