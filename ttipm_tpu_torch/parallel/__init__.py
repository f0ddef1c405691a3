"""Batched seeds: the lockstep batched fused solve, step sizes and Newton
step on one GPU (``fused_mesh``), and a config's seeds as worker processes
(``batch``)."""
