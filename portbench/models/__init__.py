"""The program's side of each configuration, one module each, named by
the configuration's ``model``: ``build(cfg, weights, device)`` builds the
port's model with no weights of its own (on the meta device), places it
on ``device`` and loads the benchmark's ``weights`` into it, and returns
(model, loss_fn) with ``loss_fn(model, batch)`` the port's loss."""
