from .analysis import (Roofline, analyze_compiled, collective_bytes,
                       roofline_terms)

__all__ = ["Roofline", "analyze_compiled", "collective_bytes",
           "roofline_terms"]
