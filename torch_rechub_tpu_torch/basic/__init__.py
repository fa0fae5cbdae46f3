from . import activation, callback, features, initializers, layers, loss, metric, tracking

__all__ = ["activation", "callback", "features", "initializers", "layers", "loss", "metric", "tracking"]
