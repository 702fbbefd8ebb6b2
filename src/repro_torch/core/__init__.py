"""The Hadar decision path: entities, pricing, the dual subroutine
(``dp``), its batched solver on the card (``batch_solver``), the
scheduler (``hadar``) and HadarE's job forking and Job Tracker
(``hadare``), whose copies the same scheduler places.  NumPy on the
host, kernels K4/K5 on the card."""
