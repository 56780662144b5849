"""One module per kind of configuration (its ``task`` key): set-up, the measured window, and the judging
of what the window produced against the plain reference."""
