"""The batches a configuration's ``inputs`` names, one module each, made
on the device from the run's seed in one call a tensor: ``pool`` gives
the traffic's ``pool`` batches, cycled through by the steps; ``rows``
takes the first n rows of a batch; ``samples`` counts a batch's
samples."""
