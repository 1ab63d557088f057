"""Plain PyTorch references of the configurations, one module a model,
named by a configuration's ``reference``; they import nothing of the port."""
