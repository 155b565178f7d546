from ft_fsd_path_planning_torch.demo.json_demo import main

if __name__ == "__main__":
    main()
