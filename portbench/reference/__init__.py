"""The plain reference the comparison that decides ``correct`` runs: no
import of the program, nothing the program made."""
