"""The port's LM training stack: data, optimizer, checkpoints, the train
loop, and asynchronous data-parallel training as a fixed-point problem
(``async_dp``, ``diloco``)."""
