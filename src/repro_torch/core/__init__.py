"""Collective schedules, SUMMA, FCL and the overlapped matmuls on a stacked mesh."""
