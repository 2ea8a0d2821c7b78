"""Sibyl (thesis Ch. 7): reinforcement-learning data placement in a
hybrid storage system — the simulator (`env`), MSRC-like traces
(`traces`), the heuristic baselines (`policies`) and the DQN agent on
PyTorch (`agent`)."""
