"""portbench: the benchmark of the PyTorch/CUDA port
(``vitparticlefiltertracker_tpu_torch``). See README.md."""
