"""The plain reference that decides ``correct``: ``model`` builds the
recipe and the starting weights from a configuration file, ``train`` runs
the first training steps and compares, ``view`` renders a viewer frame and
compares.  Nothing here imports the program."""
