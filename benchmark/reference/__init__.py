"""The plain reference the benchmark holds the program against.

Plain PyTorch in float32 with TF32 off: an MLP's loss, gradient and
Hessian-vector product by autograd (:mod:`.mlp`), the two-loop recursion and
the Armijo search with quadratic interpolation (:mod:`.lbfgs`), the S-LBFGS
and SGD epochs (:mod:`.stochastic`) and a frozen copy of the minibatch
draw (:mod:`.sampling`); the control's TF32 in :mod:`.precision`.
Nothing here imports the program under test; what the program derived
from the inputs is worked out again.
"""
