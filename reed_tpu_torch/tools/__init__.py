"""Command-line tools of the port (convergence runs)."""
