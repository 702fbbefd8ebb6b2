"""The Hadar decision path: entities, pricing, the dual subroutine
(``dp``), its batched solver on the card (``batch_solver``) and the
scheduler (``hadar``).  NumPy on the host, kernels K4/K5 on the card."""
