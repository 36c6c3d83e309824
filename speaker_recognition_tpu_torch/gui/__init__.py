"""Web GUI on the port's session API (src/gui/gui.py re-hosted as a
single-page web app). See server.py for the endpoint map."""

from .server import GuiApp, make_server, main

__all__ = ["GuiApp", "make_server", "main"]
