"""The byte and operation counts of the work the program does."""
