"""The plain references, one module a model family (`<family>.py`: `build`),
over frozen copies of the models (`frozen/`), and the reference training
step (`train_step.py`). They import nothing of the program and nothing of
JAX; they compute in f32 with TF32 off.
"""
