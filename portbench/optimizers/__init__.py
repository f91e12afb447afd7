"""The optimizers a traffic file names, one module each: ``program``
builds the ``torch.optim`` optimizer the program wraps in
``DistributedOptimizer``; ``step`` is the plain update the reference
applies; ``first_grad`` works out, from the program's optimizer state
after one step, the gradient that step was given."""
