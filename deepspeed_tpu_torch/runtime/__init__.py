"""Runtime of the port: the typed configs, the training engine and its
parts (loss scaler, LR schedules, gradient norms, ``ModelSpec``)."""
