from repro_torch.serve.engine import Request, ServeEngine, ServeStats

__all__ = ["ServeEngine", "Request", "ServeStats"]
