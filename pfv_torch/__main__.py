"""`python -m pfv_torch` runs the command-line tool."""

from pfv_torch.cli import main

main()
