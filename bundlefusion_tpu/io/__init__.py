def require_cv2():
    """OpenCV, imported on demand: only JPEG/PNG image files and the debug
    visualizations need it, never the synthetic or .sens-depth path."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "OpenCV (the cv2 module) is required to read or write JPEG/PNG "
            "images; it is not installed"
        ) from e
    return cv2
