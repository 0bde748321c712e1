"""The interactive viewer (viewer/app.py)."""
