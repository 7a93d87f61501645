"""Work counts (bytes moved and operations) of the operations the cells
run, from their shapes and the solver's iteration counts (``work``), and
the card's data-sheet peaks (``peaks``). Imports nothing of the port."""
